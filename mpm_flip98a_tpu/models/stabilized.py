"""The stabilized MPM free-surface flow solver — the framework's flagship.

This is the JAX reconstruction of the reference's withheld core
module `functionsConfidential.py` (absent by policy, reference:
README.md:23-25, .gitignore:6).  Its behaviour is rebuilt from the field
declarations (fields.py:4-51), the config switch set (config.py:15-46), the
driver loop (exec.py), and the C++ validation analogue — the reconstruction
documented in SURVEY.md section 2.3.  Every feature switch of the reference
is implemented:

  switch_vt_I_APIC   (config.py:18) -> ``MPMConfig.transfer`` PIC/APIC
  switch_overlineF   (config.py:19) -> ``MPMConfig.use_fbar`` cell-averaged
                                       volume ratio (StabilizationFields,
                                       fields.py:33-36)
  switch_penaltyEBC  (config.py:20) -> ``MPMConfig.use_penalty_ebc`` wall
                                       penalty folded into a matrix-valued
                                       nodal mass + per-node d x d solve
                                       (GridFields.mass_grid, fields.py:28;
                                       PenaltyMethodFields, fields.py:46-51)
  switch_kernelFunction (config.py:21) -> ``MPMConfig.kernel`` B-spline/tent
  pressureMixingRatio (config.py:28) -> grid-projected vs pointwise pressure
                                       and divergence (ProjectionFields,
                                       fields.py:39-43; pressure_grid,
                                       fields.py:30)
  flipBlendParameter (config.py:29) -> PIC/APIC <-> FLIP velocity blend
                                       using the saved pre-force grid
                                       velocity (velocity_grid_initial,
                                       fields.py:27); alpha = 0.98 is the
                                       repo-naming FLIP98A blend
  valueType          (config.py:17) -> dtype parameter (fp32/fp64/bf16)
  dimension          (config.py:22) -> dim-generic (2D and 3D)

Pipeline per substep (SURVEY.md section 2.3 reconstruction):
  1. projection P2G     : scatter w V, w V p, w V div(v) -> grid
                          (volume_grid, pressure_grid, divergence fields)
  2. F-bar cell average : scatter V0 J / V0 to cells, gather Jbar
  3. stress             : material dispatch (models/materials.py) using the
                          mixed pressure/divergence
  4. momentum P2G       : one fused scatter of [momentum, momentum+force,
                          mass] channels (force fused MLS-MPM style,
                          mls-mpm88-explained.cpp:84-99)
  5. grid update        : nodal (matrix) mass solve, gravity, wall BCs
  6. G2P                : FLIP/PIC/APIC blended velocity, general APIC D
                          matrix for non-B-spline kernels, advection,
                          F/J update, consistency diagnostics
                          (fields.py:15-18)

Everything is one jit region per substep; `run_frames` batches the
reference's 10,000 substeps/frame (exec.py:21) in a `lax.fori_loop`.

Design notes on the reconstruction (these choices are ours; the reference's exact withheld formulas are unpublished):
  - Pressure comes from an EOS on the F-bar volume ratio; the "mixed"
    pressure blends a grid-projected (hence smoothed) pressure with the
    pointwise one, the standard cure for checkerboard pressure noise in
    near-incompressible MPM.
  - J evolves via the (optionally mixed) velocity divergence,
    J <- J (1 + dt div v), the linearised det update; F is kept for
    solid materials.
  - Penalty EBC solves (m I + dt beta n(x)n) v = p at wall nodes, i.e. an
    implicit normal-velocity penalty; beta = penalty rho dx^2
    (config.py:45).  Walls are the 4 planes of the physical box, which
    sits 2 padding cells inside the background grid (config.py:39).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from mpm_flip98a_tpu.config import KernelKind, MPMConfig, Physics, TransferKind
from mpm_flip98a_tpu.models import materials as mat
from mpm_flip98a_tpu.ops import mathx
from mpm_flip98a_tpu.ops import transfer
from mpm_flip98a_tpu.ops import weights as W
from mpm_flip98a_tpu.state import Grid, Particles

# The physical domain sits PAD cells inside the background grid on every
# side (4 padding cells total per axis, reference: config.py:39).
PAD = 2.0


@dataclasses.dataclass(frozen=True)
class WallBC:
    """Wall boundary handling when penalty EBC is off."""

    kind: str = "slip"  # 'slip' (zero normal) | 'sticky' (zero all)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Static bundle: numerics + physics + materials (hashable, jit-static)."""

    cfg: MPMConfig
    physics: Physics = Physics()
    params: mat.MaterialParams = mat.MaterialParams()
    materials_present: Tuple[int, ...] = (mat.WEAKLY_COMPRESSIBLE_FLUID,)
    wall: WallBC = WallBC()
    # Rigid SDF colliders (extension — models/colliders.py): static
    # sphere/halfspace obstacles with slip/sticky surfaces and optional
    # constant surface velocity, applied as a grid-velocity projection
    # in every path's grid update.
    colliders: tuple = ()
    # Absolute grid-mass floor (kg): nodes below it are treated as empty
    # in the grid update.  Scene builders set 1e-8 x the lightest particle
    # mass; 0.0 falls back to the relative floor 1e-8 * max(g_m).  An
    # absolute floor is shard-invariant — the relative one is evaluated
    # per-shard inside shard_map, so neighboring shards could disagree on
    # `has` for shared halo rows (advisor r2 finding).
    mass_floor: float = 0.0


@dataclasses.dataclass
class GridContext:
    """Where and how grid buffers live for one execution strategy.

    - single chip   : global buffers, identity reduce (the default)
    - replicated DP : global buffers, reduce = psum over the mesh axis
                      (parallel/replicated.py)
    - slab domain decomposition : slab-local buffers; `base_shift` maps
      global stencil bases into the local buffer, `row_index0` carries the
      global node row ids for wall masks, and reduce = halo-reduce +
      halo-gather (parallel/domain.py)

    The physics below is written once against this context; the strategies
    only swap buffers and reductions.
    """

    node_shape: Tuple[int, ...]
    cell_shape: Tuple[int, ...]
    base_shift: jax.Array = None   # (dim,) int32 subtracted from global bases
    row_index0: jax.Array = None   # global node row index of local axis-0 rows
    # Slab-decomposition hooks for grid-side derivative chains (CSF) and
    # grid-side iterative solves (incompressible projection):
    axis: str = None               # mesh axis name for pmax/psum scalars
    halo_exchange: Callable = None  # refresh axis-0 halo rows from neighbors
    own_rows: jax.Array = None     # bool (R,): locally-owned axis-0 rows

    @staticmethod
    def single(cfg: MPMConfig) -> "GridContext":
        return GridContext(
            node_shape=cfg.grid_shape,
            cell_shape=(cfg.num_cells,) * cfg.dim,
        )

    def localize(self, idx: jax.Array) -> jax.Array:
        if self.base_shift is None:
            return idx
        return idx - self.base_shift


def _mass_floor(scene: Scene, g_m: jax.Array) -> jax.Array:
    """Grid-mass emptiness threshold (see Scene.mass_floor)."""
    if scene.mass_floor > 0.0:
        return jnp.asarray(scene.mass_floor, g_m.dtype)
    return jnp.asarray(1e-8, g_m.dtype) * jnp.max(g_m)


def _grid_coords(p_x: jax.Array, cfg: MPMConfig):
    """Particle position in grid units including the padding shift."""
    dt = p_x.dtype
    return p_x * jnp.asarray(cfg.inv_dx, dt) + jnp.asarray(PAD, dt)


def _weights(gx: jax.Array, cfg: MPMConfig):
    offsets = W.stencil_offsets(cfg.dim)
    base = jnp.floor(gx - jnp.asarray(0.5, gx.dtype)).astype(jnp.int32)
    fx = gx - base.astype(gx.dtype)
    w_axes = W.kernel_weights(fx, cfg.kernel)
    wst = W.stencil_weights(w_axes, offsets)
    return offsets, base, fx, wst


def _cell_index(gx: jax.Array, cfg: MPMConfig) -> jax.Array:
    """Cell-centered index for the F-bar average (StabilizationFields,
    fields.py:33-36 — cell arrays are (num_cells,)^dim)."""
    return jnp.clip(
        jnp.floor(gx).astype(jnp.int32), 0, cfg.num_cells - 1
    )


def _flat_cell(cell: jax.Array, shape) -> Tuple[jax.Array, jax.Array]:
    """Flatten (possibly out-of-bounds) cell indices; returns (flat, mask)."""
    in_bounds = jnp.all(
        (cell >= 0) & (cell < jnp.asarray(shape, jnp.int32)[None, :]), axis=-1
    )
    cell = jnp.clip(cell, 0, jnp.asarray(shape, jnp.int32) - 1)
    strides = np.concatenate(
        [np.cumprod(np.asarray(shape[1:], np.int64)[::-1])[::-1], [1]]
    ).astype(np.int32)
    flat = jnp.sum(cell * jnp.asarray(strides)[None, :], axis=-1)
    return flat, in_bounds


def _scatter_cells(values: jax.Array, cell: jax.Array, shape) -> jax.Array:
    """Nearest-cell scatter-add: values (N, c) by cell (N, d) -> (shape, c)."""
    flat, in_bounds = _flat_cell(cell, shape)
    values = jnp.where(in_bounds[..., None], values, 0)
    out = jnp.zeros((int(np.prod(shape)), values.shape[-1]), values.dtype)
    return out.at[flat].add(values).reshape(tuple(shape) + (values.shape[-1],))


def fbar_jbar(
    p: Particles,
    scene: Scene,
    grid_reduce: Callable = None,
    ctx: "GridContext" = None,
) -> jax.Array:
    """Cell-averaged volume ratio (overline-F stabilization,
    reference: config.py:19, fields.py:33-36).

    Jbar_c = sum_{p in c} V0_p J_p / sum_{p in c} V0_p, gathered back to the
    particle's cell.  Falls back to the particle J where the cell is empty.
    """
    cfg = scene.cfg
    ctx = ctx or GridContext.single(cfg)
    gx = _grid_coords(p.x, cfg)
    cell = ctx.localize(_cell_index(gx, cfg))
    vals = jnp.stack([p.volume0 * p.J, p.volume0], axis=-1)
    cells = _scatter_cells(vals, cell, ctx.cell_shape)
    if grid_reduce is not None:
        cells = grid_reduce(cells)
    flat, in_bounds = _flat_cell(cell, ctx.cell_shape)
    num = jnp.where(in_bounds, cells.reshape(-1, 2)[flat, 0], 0.0)
    den = jnp.where(in_bounds, cells.reshape(-1, 2)[flat, 1], 0.0)
    return jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), p.J)


def _axis_indices(cfg: MPMConfig, grid_shape, row_index0=None, row_index1=None):
    """Per-axis global node indices of a (possibly slab-local) grid buffer.

    `row_index0` / `row_index1` override axes 0 / 1 with global indices
    when the grid is a local window of a domain-decomposed run
    (parallel/domain.py, parallel/fast_domain3d.py)."""
    idx = [jnp.arange(s) for s in grid_shape]
    if row_index0 is not None:
        idx[0] = row_index0
    if row_index1 is not None:
        idx[1] = row_index1
    return idx


def _wall_normal_diag(
    cfg: MPMConfig, dtype, grid_shape=None, row_index0=None, row_index1=None
) -> jax.Array:
    """sum_walls n (x) n at every node, as its diagonal (axis-aligned walls
    => the penalty matrix is diagonal).  Shape (G..., d).

    Wall planes: node index == PAD and == G-1-PAD on each axis — the
    physical box faces (PenaltyMethodFields wall node lists,
    fields.py:46-51).
    """
    g = cfg.num_grids
    grid_shape = grid_shape or (g,) * cfg.dim
    lo, hi = int(PAD), g - 1 - int(PAD)
    axis_idx = _axis_indices(cfg, grid_shape, row_index0, row_index1)
    diag = []
    for a in range(cfg.dim):
        on_wall = (axis_idx[a] <= lo) | (axis_idx[a] >= hi)
        shape = [1] * cfg.dim
        shape[a] = grid_shape[a]
        diag.append(jnp.broadcast_to(on_wall.reshape(shape), grid_shape))
    return jnp.stack(diag, axis=-1).astype(dtype)


def _apply_wall_bc(
    v: jax.Array, cfg: MPMConfig, wall: WallBC, grid_shape=None, row_index0=None,
    row_index1=None,
) -> jax.Array:
    """Slip/sticky walls on the padded band (non-penalty path).

    Nodes at or outside the physical box faces: slip zeroes the inward
    normal component only when pointing out of the box; sticky zeroes all
    components (the C++ analogue: mls-mpm88-explained.cpp:122-128).
    """
    g = cfg.num_grids
    grid_shape = grid_shape or (g,) * cfg.dim
    lo, hi = int(PAD), g - 1 - int(PAD)
    axis_idx = _axis_indices(cfg, grid_shape, row_index0, row_index1)
    for a in range(cfg.dim):
        shape = [1] * cfg.dim
        shape[a] = grid_shape[a]
        low_band = (axis_idx[a] <= lo).reshape(shape)
        high_band = (axis_idx[a] >= hi).reshape(shape)
        va = v[..., a]
        if wall.kind == "sticky":
            v = jnp.where((low_band | high_band)[..., None], 0.0, v)
        else:  # slip: clamp outgoing normal velocity, keep tangential
            va = jnp.where(low_band, jnp.maximum(va, 0.0), va)
            va = jnp.where(high_band, jnp.minimum(va, 0.0), va)
            v = v.at[..., a].set(va)
    return v


def _roll0(c: jax.Array, shift: int, axis: int) -> jax.Array:
    """Shift with zero fill (vacuum outside the buffer): the color field
    convention treats everything beyond the padded grid as empty."""
    r = jnp.roll(c, shift, axis=axis)
    edge = 0 if shift > 0 else -1
    return r.at[(slice(None),) * axis + (edge,)].set(0.0)


def _cdiff(c: jax.Array, axis: int, inv_dx) -> jax.Array:
    """Central difference with zero-extended boundaries.

    Unlike `jnp.gradient` (one-sided at buffer edges), this stencil is
    translation invariant, so a slab-local buffer with valid halo rows
    reproduces the single-device values exactly on its interior."""
    return (_roll0(c, -1, axis) - _roll0(c, 1, axis)) * (0.5 * inv_dx)


def _csf_force(
    g_m: jax.Array, cfg: MPMConfig, physics, dtype, ctx: "GridContext" = None
) -> jax.Array:
    """Continuum-surface-force density sigma kappa grad(c~) on the grid.

    The normalized, binomially-smoothed nodal mass field is the color
    function c~ in [0, 1]; n = grad c~, kappa = -div(n / |n|).  Nodes far
    from the interface (|n| below 1% of the global max) contribute
    nothing — this also kills the B-spline deposition ripple that
    survives the smoothing.  EXTENSION beyond the reference's switch set
    (config.py:18-29).  Dim-agnostic; also consumed by BOTH fast
    paths on their P2G mass planes (fast2d/fast3d grid updates),
    single-device and sharded.

    Slab decomposition (ctx.axis set): every derivative in the chain
    consumes one ring of valid axis-0 rows, so after each radius-1 stage
    the outermost halo rows are refreshed from the neighbors' interiors
    (ctx.halo_exchange = domain.halo_gather) and the two global maxima
    ride a pmax — the sharded result then matches single-device exactly
    (tests/test_surface_tension.py sharded case)."""
    d = g_m.ndim
    sharded = ctx is not None and ctx.axis is not None

    def gmax(x):
        m = jnp.max(x)
        return jax.lax.pmax(m, ctx.axis) if sharded else m

    def sync(x):
        return ctx.halo_exchange(x) if sharded else x

    inv_dx = jnp.asarray(cfg.inv_dx, dtype)
    c = g_m / jnp.maximum(gmax(g_m), jnp.asarray(1e-30, dtype))
    # One binomial (1,2,1)/4 pass per axis smooths the deposition ripple.
    for a in range(d):
        c = 0.25 * _roll0(c, 1, a) + 0.5 * c + 0.25 * _roll0(c, -1, a)
    c = sync(c)
    n = jnp.stack([_cdiff(c, a, inv_dx) for a in range(d)], axis=-1)
    n = sync(n)
    mag = jnp.sqrt(jnp.sum(n * n, axis=-1))
    near = mag > 0.01 * gmax(mag)
    safe = jnp.where(near, mag, 1.0)
    nhat = jnp.where(near[..., None], n / safe[..., None], 0.0)
    div_nhat = sum(_cdiff(nhat[..., a], a, inv_dx) for a in range(d))
    kappa = -div_nhat
    sigma = jnp.asarray(cfg.surface_tension, dtype)
    force = jnp.where(near[..., None], sigma * kappa[..., None] * n, 0.0)
    # kappa is one-sided on the outermost halo rows — refresh them so the
    # halo copies of the nodal force agree with the owning shard.
    return sync(force)


def substep_grid(
    p: Particles,
    scene: Scene,
    grid_reduce: Callable = None,
    ctx: GridContext = None,
    t=None,
) -> Tuple[Particles, Grid]:
    """One substep; returns the new particle state and the post-update grid
    (for diagnostics/rendering — fori_loop callers use `substep`).

    `grid_reduce` is applied to every raw P2G scatter result before it is
    consumed — identity single-chip, `psum` for replicated particle DP
    (parallel/replicated.py), halo-reduce+gather for slab decomposition
    (parallel/domain.py).  `ctx` describes the grid buffers (global vs
    slab-local).  `t` (traced scalar, simulation seconds) advects
    kinematic colliders; None = all colliders static."""
    if grid_reduce is None:
        grid_reduce = lambda t: t
    cfg = scene.cfg
    ctx = ctx or GridContext.single(cfg)
    d = cfg.dim
    dt_ = p.x.dtype
    dt = jnp.asarray(cfg.dt, dt_)
    dx = jnp.asarray(cfg.dx, dt_)
    inv_dx = jnp.asarray(cfg.inv_dx, dt_)

    offsets, base_global, fx, wst = _weights(_grid_coords(p.x, cfg), cfg)
    base = ctx.localize(base_global)
    grid_shape = ctx.node_shape

    # ---- strain rate and pointwise divergence from last step's C ------
    eps = 0.5 * (p.C + mathx.transpose(p.C))
    div_point = mathx.trace(p.C)

    # ---- projection pass: volume / pressure / divergence to the grid --
    # (ProjectionFields fields.py:39-43, volume_grid/pressure_grid
    #  fields.py:29-30.)  Only needed when mixing is on.
    ratio = cfg.pressure_mixing_ratio
    jbar = fbar_jbar(p, scene, grid_reduce, ctx) if cfg.use_fbar else p.J
    p_point = mat.fluid_pressure(scene.params, jbar)
    if ratio > 0.0:
        vol_n = p.volume0 * jbar
        proj_vals = wst[..., None] * jnp.stack(
            [vol_n, vol_n * p_point, vol_n * div_point], axis=-1
        )[:, None, :]
        proj = grid_reduce(transfer.p2g_scatter(proj_vals, base, offsets, grid_shape))
        den = proj[..., 0]
        safe = jnp.where(den > 0, den, 1.0)
        p_grid = jnp.where(den > 0, proj[..., 1] / safe, 0.0)
        div_grid = jnp.where(den > 0, proj[..., 2] / safe, 0.0)
        back = transfer.g2p_gather(
            jnp.stack([p_grid, div_grid], axis=-1), base, offsets
        )
        p_smooth = jnp.sum(wst[..., None] * back, axis=1)
        r = jnp.asarray(ratio, dt_)
        pressure = r * p_smooth[..., 0] + (1 - r) * p_point
        div_used = r * p_smooth[..., 1] + (1 - r) * div_point
    else:
        pressure = p_point
        div_used = div_point

    # ---- stress (material dispatch) -----------------------------------
    tau = mat.tau_hat(
        scene.params,
        p.material,
        p.volume0,
        p.F,
        jbar,
        pressure,
        eps,
        scene.materials_present,
        jp=p.Jp,
    )
    sigma = tau / jnp.maximum(p.volume0 * jbar, jnp.asarray(1e-30, dt_))[..., None, None]

    # ---- fused momentum P2G -------------------------------------------
    # Channels: [momentum (d), momentum+force (d), mass (1), volume (1)].
    # Force fused MLS-MPM style: affine_force = -dt Dinv tau acting on the
    # physical node offset (mls-mpm88-explained.cpp:79-99).
    dpos_grid = W.stencil_dpos(fx, offsets)           # grid units (N, S, d)
    dpos_phys = dpos_grid * dx
    if cfg.transfer == TransferKind.APIC:
        vel_aff = p.C
    else:
        vel_aff = jnp.zeros_like(p.C)
    mv_pure = p.mass[:, None, None] * (
        p.v[:, None, :]
        + jnp.einsum("nab,nsb->nsa", vel_aff, dpos_phys, precision="highest")
    )
    dinv = 4.0 * inv_dx * inv_dx
    force_aff = (-dt * dinv) * tau
    mv_forced = mv_pure + jnp.einsum(
        "nab,nsb->nsa", force_aff, dpos_phys, precision="highest"
    )
    ones = jnp.ones_like(wst)
    extra = jnp.stack(
        [p.mass[:, None] * ones, (p.volume0 * jbar)[:, None] * ones], axis=-1
    )
    channels = jnp.concatenate([mv_pure, mv_forced, extra], axis=-1)
    g_out = grid_reduce(
        transfer.p2g_scatter(wst[..., None] * channels, base, offsets, grid_shape)
    )
    g_mv0 = g_out[..., 0:d]
    g_mv1 = g_out[..., d : 2 * d]
    g_m = g_out[..., 2 * d]
    g_vol = g_out[..., 2 * d + 1]

    # ---- grid update ---------------------------------------------------
    # Mass floor — see fast3d._grid_update: knife-edge stencil taps leave
    # ~1e-15-mass nodes whose momentum/mass ratio is fp noise.  Absolute
    # (scene.mass_floor) when available: shard-invariant under shard_map.
    has_mass = g_m > _mass_floor(scene, g_m)
    safe_m = jnp.where(has_mass, g_m, 1.0)
    v0 = jnp.where(has_mass[..., None], g_mv0 / safe_m[..., None], 0.0)

    grav = jnp.asarray(cfg.gravity_acceleration(scene.physics), dt_)
    rhs = g_mv1 + dt * g_m[..., None] * grav
    if cfg.surface_tension > 0.0:
        # EXTENSION (beyond the reference switch set): continuum surface
        # force (Brackbill et al. 1992) from the nodal mass field as
        # color function — F/V = sigma kappa grad(c~), applied as a nodal
        # force dt F/V * (m/rho).
        rhs = rhs + dt * _csf_force(
            g_m, cfg, scene.physics, dt_, ctx
        ) * (g_m / jnp.asarray(scene.physics.particle_density, dt_))[..., None]
    if cfg.use_penalty_ebc:
        # Matrix nodal mass: A = m I + dt beta sum n(x)n  (diagonal for the
        # axis-aligned box), solved per node (fields.py:28 mass_grid 2x2).
        beta = jnp.asarray(cfg.penalty_parameter(scene.physics), dt_)
        pen_diag = _wall_normal_diag(cfg, dt_, grid_shape, ctx.row_index0)
        a_mat = g_m[..., None, None] * jnp.eye(d, dtype=dt_) + (
            dt * beta * pen_diag[..., None] * jnp.eye(d, dtype=dt_)
        )
        v_new = jnp.where(
            has_mass[..., None], mathx.solve(a_mat, rhs), 0.0
        )
    else:
        v_new = jnp.where(has_mass[..., None], rhs / safe_m[..., None], 0.0)
        v_new = _apply_wall_bc(v_new, cfg, scene.wall, grid_shape, ctx.row_index0)

    col_solid = None
    if scene.colliders:
        # EXTENSION: rigid SDF colliders (models/colliders.py) — a
        # pointwise grid-velocity projection, after the wall/penalty BC.
        from mpm_flip98a_tpu.models import colliders as _col

        axis_idx = _axis_indices(cfg, grid_shape, ctx.row_index0)
        shaped = [
            axis_idx[a].reshape(
                tuple(grid_shape[a] if i == a else 1 for i in range(d))
            )
            for a in range(d)
        ]
        coords = _col.node_coords(cfg, shaped, dt_)
        comps = _col.project(
            [v_new[..., a] for a in range(d)], coords, scene.colliders, t
        )
        v_new = jnp.stack(comps, axis=-1)
        # The pressure solve below treats collider interiors as solid
        # (Neumann), keeping their BC velocities pinned while their
        # motion sources the RHS divergence at adjacent fluid nodes.
        col_solid = _col.inside_any(coords, scene.colliders, t)

    if cfg.incompressible:
        # EXTENSION: nodal Chorin projection (models/projection.py) —
        # divergence-free grid velocities each substep; see the config
        # switch note.  Solid wall nodes keep their BC values (the
        # projection only moves non-solid edges strictly inside the box).
        # Sharded slabs run the same PCG with psum dot products and a
        # per-iteration halo refresh (projection module docstring).
        from mpm_flip98a_tpu.models import projection as _proj

        p_floor = _mass_floor(scene, g_m)
        if ctx.axis is not None and scene.mass_floor <= 0.0:
            # Shard-invariant relative floor: halo rows must classify
            # fluid/air identically on both owners.
            p_floor = jax.lax.pmax(p_floor, ctx.axis)
        vs, _, _ = _proj.project_planes(
            tuple(v_new[..., a] for a in range(d)),
            g_m, p_floor,
            dx=float(cfg.dx), lo=int(PAD), hi=cfg.num_grids - 1 - int(PAD),
            iters=int(cfg.pressure_iters), tol=float(cfg.pressure_tol),
            row_index0=ctx.row_index0, axis=ctx.axis,
            halo=ctx.halo_exchange, own=ctx.own_rows,
            solid_extra=col_solid,
        )
        v_new = jnp.stack(vs, axis=-1)

    grid = Grid(
        v=v_new,
        v0=v0,
        m=g_m[..., None, None] * jnp.eye(d, dtype=dt_),
        volume=g_vol,
        pressure=(
            p_grid if ratio > 0.0 else jnp.zeros_like(g_vol)
        ),
    )

    # ---- G2P ----------------------------------------------------------
    both = transfer.g2p_gather(
        jnp.concatenate([v_new, v0], axis=-1), base, offsets
    )  # (N, S, 2d)
    wv = wst[..., None] * both
    v_pic = jnp.sum(wv[..., 0:d], axis=1)
    v_old_gathered = jnp.sum(wv[..., d : 2 * d], axis=1)
    dv_flip = v_pic - v_old_gathered

    # Velocity gradient: quadratic B-spline has constant APIC
    # D = (dx^2/4) I (mls-mpm88-explained.cpp:79); general kernels use the
    # per-particle D = sum w dpos dpos^T, inverted in closed form.
    b_mat = jnp.einsum(
        "nsa,nsb->nab", wv[..., 0:d], dpos_phys, precision="highest"
    )
    if cfg.kernel == KernelKind.BSPLINE:
        c_new = dinv * b_mat
    else:
        d_mat = jnp.einsum(
            "ns,nsa,nsb->nab", wst, dpos_phys, dpos_phys, precision="highest"
        )
        # Regularise: empty/degenerate D (tent kernel on a node line).
        d_mat = d_mat + jnp.asarray(1e-12, dt_) * jnp.eye(d, dtype=dt_)
        c_new = mathx.mm(b_mat, mathx.inv(d_mat))

    alpha = jnp.asarray(cfg.flip_blend, dt_)
    v_p = alpha * (p.v + dv_flip) + (1 - alpha) * v_pic

    x_new = p.x + dt * v_pic
    f_new = mathx.mm(jnp.eye(d, dtype=dt_)[None] + dt * c_new, p.F)
    # Snow-plasticity singular-value clamp + Jp tracking (static no-op
    # unless the scene declares a clamping material; mls-mpm88:164-177).
    f_new, jp_new = mat.plastic_update(
        scene.params, p.material, f_new, p.Jp, scene.materials_present
    )
    # J via the divergence rate — the stabilized volumetric update.  With
    # pressure mixing on, the grid-projected (smoothed) divergence drives J
    # with a one-substep lag (div_used comes from the pre-update C): the
    # standard explicit treatment; otherwise the fresh pointwise trace.
    div_new = mathx.trace(c_new)
    div_for_j = div_used if ratio > 0.0 else div_new
    j_new = p.J * (1.0 + dt * div_for_j)

    # Kernel-consistency diagnostics (fields.py:15-18): partition of unity
    # and linear-field reproduction  sum_i w_i x_i - x_p.
    pou = jnp.sum(wst, axis=1)
    node_pos = (
        base_global[:, None, :].astype(dt_) + jnp.asarray(offsets, dt_)[None] - PAD
    ) * dx
    cons = jnp.einsum("ns,nsa->na", wst, node_pos, precision="highest") - p.x

    return (
        Particles(
            x=x_new,
            v=v_p,
            C=c_new,
            F=f_new,
            J=j_new,
            stress=sigma,
            material=p.material,
            volume0=p.volume0,
            mass=p.mass,
            density=p.density / (1.0 + dt * div_for_j),
            pressure=pressure,
            div_v=div_new,
            pou=pou,
            consistency=cons,
            Jp=jp_new,
        ),
        grid,
    )


def substep(
    p: Particles,
    scene: Scene,
    grid_reduce: Callable = None,
    ctx: GridContext = None,
    t=None,
) -> Particles:
    return substep_grid(p, scene, grid_reduce, ctx, t)[0]


def make_substep(scene: Scene) -> Callable[[Particles], Particles]:
    @jax.jit
    def fn(p: Particles) -> Particles:
        return substep(p, scene)

    return fn


@partial(jax.jit, static_argnames=("scene", "n_substeps"))
def run(p: Particles, scene: Scene, n_substeps: int, t0=None) -> Particles:
    """Batch substeps on-device (exec.py:21-26 pattern: 10k substeps/frame
    per host round-trip).  `t0` (traced scalar, simulation seconds at
    entry — the driver's total_time) drives kinematic colliders; substep
    i sees t = t0 + i dt.  None (or no moving collider) keeps the body
    time-free."""
    if t0 is None or not _col_moving(scene):
        return jax.lax.fori_loop(
            0, n_substeps, lambda _, s: substep(s, scene), p
        )
    dt = scene.cfg.dt
    return jax.lax.fori_loop(
        0,
        n_substeps,
        lambda i, s: substep(s, scene, t=jnp.asarray(t0) + i * dt),
        p,
    )


def _col_moving(scene: Scene) -> bool:
    from mpm_flip98a_tpu.models import colliders as _col

    return bool(scene.colliders) and _col.any_moving(scene.colliders)
