"""Fast 2D fluid solver: the row-bucketed production path.

The flagship FLIP98A weakly-compressible free-surface pipeline (APIC
transfer + FLIP-blend + EOS fluid + slip box) on fp32 particle state kept
in row buckets.  Numerics are the same substep as `models/stabilized.py`
restricted to the fluid feature set — the test suite asserts agreement.
The transfers are one XLA scatter-add (P2G) and one gather (G2P) over the
bucket slots (ops/transfer.p2g_slots / g2p_slots); dead slots point out
of range and cost nothing.

State lives permanently in the bucketed (R, K) slot layout; `rebucket`
(one XLA sort) triggers adaptively from a drift check — every few hundred
substeps at CFL-respecting dt — which keeps each particle within one row
of its bucket (the slab-sharded path's halo window relies on it).

Feature switches covered here: APIC/PIC transfer, FLIP blend alpha,
linear/Tait EOS, slip/sticky walls, penalty EBC, fused F-bar /
pressure-mixing stabilization (nodal averages carried with a one-substep
lag through extra transfer channels), the CSF surface-tension and
incompressible-projection extensions (grid-side, in the XLA grid
update), and the SNOW material (tracked Jp).  The general XLA path
(models/stabilized.py) remains the reference semantics (two-pass
projection, no lag).
"""

from __future__ import annotations

import dataclasses
import os as _os
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from mpm_flip98a_tpu.config import EOSKind, MPMConfig, TransferKind
from mpm_flip98a_tpu.models import materials as mat
from mpm_flip98a_tpu.models.stabilized import PAD, Scene
from mpm_flip98a_tpu.ops import binning, transfer
from mpm_flip98a_tpu.state import Particles


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_pytree_dataclass
class FluidBuckets:
    """Row-bucketed particle state; every field (R, K) f32 (mat: int32).

    Carries the deformation gradient and a material id so solid materials
    (neo-Hookean / fixed corotated) run through the same fast kernels as
    the fluid — the kernels only ever see the assembled affine channels."""

    x0: jax.Array
    x1: jax.Array
    v0: jax.Array
    v1: jax.Array
    C00: jax.Array
    C01: jax.Array
    C10: jax.Array
    C11: jax.Array
    F00: jax.Array
    F01: jax.Array
    F10: jax.Array
    F11: jax.Array
    J: jax.Array
    mass: jax.Array
    vol0: jax.Array
    mat: jax.Array       # int32 material id (models/materials.py)
    Jp: jax.Array        # plastic volume ratio (SNOW hardening state)
    # Fused-stabilization state (one-substep-lag nodal averages; only
    # meaningful when use_fbar / pressure mixing is on):
    jbar_s: jax.Array    # gathered nodal volume-ratio average
    p_s: jax.Array       # gathered grid-projected pressure
    div_s: jax.Array     # gathered grid-projected divergence
    mask: jax.Array      # f32 0/1
    overflow: jax.Array  # int32 scalar, cumulative rebucket overflow

    @property
    def shape(self) -> Tuple[int, int]:
        return self.x0.shape


@dataclasses.dataclass(frozen=True)
class FastSpec:
    """Static fast-path parameters."""

    rows: int          # R = num_grids (one bucket per grid row)
    capacity: int      # K slots per row (multiple of 128)

    @staticmethod
    def for_particles(cfg: MPMConfig, p: Particles, headroom: float = None) -> "FastSpec":
        x = np.asarray(p.x)
        row = np.floor(x[:, 0] * cfg.inv_dx + PAD - 0.5).astype(np.int64)
        occ = int(np.bincount(np.clip(row, 0, cfg.num_grids - 1), minlength=cfg.num_grids).max())
        return FastSpec(rows=cfg.num_grids, capacity=capacity_for(occ, headroom))


def capacity_for(occ: int, headroom: float = None) -> int:
    """Bucket capacity for a peak per-row occupancy: headroom-padded and
    rounded up to a multiple of 128 slots.

    Every slot, live or dead, costs elementwise work in each substep, so
    headroom trades overflow safety against dead-slot work.
    MPM_HEADROOM overrides the default 1.5; the adaptive respec
    (driver._maybe_respec) re-sizes long runs with the same value."""
    if headroom is None:
        headroom = float(_os.environ.get("MPM_HEADROOM", "1.5"))
    return max(128, -(-int(headroom * occ) // 128) * 128)


def kernel_cols(cfg: MPMConfig) -> int:
    """Grid-plane column width for the fast path.

    The common power-of-two-plus-one grids (129, 513, ...) run their grid
    planes one column narrower, at a power-of-two width.  Whether that
    still pays on a GPU is an open layout question; the crop is exact.
    The grid's LAST column is massless whenever every particle's transfer
    coordinate satisfies gx1 < hi + 0.5 (hi = num_grids - 1 - PAD): a tap
    on column num_grids - 1 needs base1 = hi, i.e. the particle half a
    cell PAST the wall-band node line.  The wall clamp keeps the fluid
    inside that band, but transient ballistic penetration past hi + 0.5
    is not impossible, so `substep` additionally clips the TRANSFER
    coordinate (never the position) to hi + 0.49 when cropped: identity
    (bit-exact vs the uncropped kernel) for every particle in the safe
    band, and for a penetrator it scatters/gathers as if at the clamp
    point — mass, momentum and partition-of-unity preserved exactly.
    MPM_GCROP=0 disables the crop.
    """
    g = cfg.num_grids
    if (g - 1) % 128 == 0 and _os.environ.get("MPM_GCROP", "1") != "0":
        return g - 1
    return g


def _field_list(b: FluidBuckets):
    return (
        b.x0, b.x1, b.v0, b.v1,
        b.C00, b.C01, b.C10, b.C11,
        b.F00, b.F01, b.F10, b.F11,
        b.J, b.mass, b.vol0, b.mat, b.Jp,
        b.jbar_s, b.p_s, b.div_s,
    )


def _safe_dead_slots(b: FluidBuckets) -> FluidBuckets:
    """Give inactive slots physically neutral values (J = 1, F = I).

    bucket_by_row zero-fills dead slots; zeros there hit the 1/J Tait EOS
    power and the 1/|F00+F11, F10-F01| corotated polar normalisation, and
    the resulting inf turns into NaN under the mask multiply (0 * inf).
    Neutral fills keep every slot's math finite so masking works."""
    on = b.mask > 0
    one = lambda a: jnp.where(on, a, jnp.ones_like(a))
    return dataclasses.replace(
        b, J=one(b.J), F00=one(b.F00), F11=one(b.F11),
        Jp=one(b.Jp), jbar_s=one(b.jbar_s),
    )


def rebucket(b: FluidBuckets, cfg: MPMConfig, spec: FastSpec) -> FluidBuckets:
    """Re-sort slots into their current base-row buckets (one XLA sort)."""
    r, k = b.shape
    flat = tuple(f.reshape(-1) for f in _field_list(b))
    mask = b.mask.reshape(-1) > 0
    gx0 = flat[0] * cfg.inv_dx + PAD
    row = jnp.floor(gx0 - 0.5).astype(jnp.int32)
    fields, new_mask, overflow = binning.bucket_by_row(
        row, mask, flat, spec.rows, spec.capacity
    )
    return _safe_dead_slots(
        FluidBuckets(
            *fields,
            mask=new_mask.astype(jnp.float32),
            overflow=b.overflow + overflow,
        )
    )


def from_particles(p: Particles, cfg: MPMConfig, spec: FastSpec) -> FluidBuckets:
    """Dense Particles -> bucketed fast-path state (fp32)."""
    n = p.n
    to32 = lambda a: jnp.asarray(a, jnp.float32)
    x = to32(p.x)
    gx0 = x[:, 0] * cfg.inv_dx + PAD
    row = jnp.floor(gx0 - 0.5).astype(jnp.int32)
    flat = (
        x[:, 0], x[:, 1],
        to32(p.v)[:, 0], to32(p.v)[:, 1],
        to32(p.C)[:, 0, 0], to32(p.C)[:, 0, 1],
        to32(p.C)[:, 1, 0], to32(p.C)[:, 1, 1],
        to32(p.F)[:, 0, 0], to32(p.F)[:, 0, 1],
        to32(p.F)[:, 1, 0], to32(p.F)[:, 1, 1],
        to32(p.J), to32(p.mass), to32(p.volume0),
        p.material.astype(jnp.int32),
        to32(p.Jp),
        to32(p.J),                      # jbar_s init = J
        jnp.zeros((n,), jnp.float32),   # p_s
        jnp.zeros((n,), jnp.float32),   # div_s
    )
    fields, mask, overflow = binning.bucket_by_row(
        row, jnp.ones((n,), jnp.bool_), flat, spec.rows, spec.capacity
    )
    return _safe_dead_slots(
        FluidBuckets(*fields, mask=mask.astype(jnp.float32), overflow=overflow)
    )


def to_host(b: FluidBuckets) -> dict:
    """Host-side dense view of active slots (diagnostics / IO).

    One gathered `jax.device_get`: it issues every copy before blocking,
    so the frame pays one device round trip instead of one per field."""
    names = ("x0", "x1", "v0", "v1", "J", "mass", "vol0", "mat", "Jp")
    arrs = jax.device_get([b.mask] + [getattr(b, n) for n in names])
    mask = arrs[0] > 0
    return {n: a[mask] for n, a in zip(names, arrs[1:])}


def _axis_bands2d(cfg: MPMConfig, nrows: int, ncols: int, row_index0=None):
    """Wall-band masks broadcastable against dense (R, G) channel planes —
    same node sets as models/stabilized._apply_wall_bc (box faces at
    PAD / G-1-PAD).  `row_index0` carries GLOBAL axis-0 node indices for
    a slab-local buffer (parallel/fast_domain.py); `ncols` is the plane's
    actual column width (kernel_cols — may be num_grids - 1)."""
    g = cfg.num_grids
    lo, hi = int(PAD), g - 1 - int(PAD)
    idx0 = jnp.arange(nrows) if row_index0 is None else row_index0
    idx1 = jnp.arange(ncols)
    return (
        (idx0 <= lo)[:, None], (idx0 >= hi)[:, None],
        (idx1 <= lo)[None, :], (idx1 >= hi)[None, :],
    )


def _grid_update2d(gridsum, scene: Scene, ext: bool, row_index0, domain=None, t=None):
    """Grid momentum update on the channel-last (R, G, nch) P2G sums;
    returns the (R, G, gch) grid that G2P gathers.

    All arithmetic runs on dense per-channel (R, G) planes; the wall BC
    acts per channel with (R, 1) / (1, G) band masks."""
    cfg = scene.cfg
    dt = jnp.float32(cfg.dt)
    from mpm_flip98a_tpu.models.stabilized import _mass_floor

    g_m = gridsum[..., 4]                                  # (R, G)
    # Mass floor — see fast3d._grid_update: knife-edge taps leave
    # ~1e-15-mass nodes whose velocity update is fp noise.  Absolute
    # (scene.mass_floor) when available: shard-invariant under shard_map.
    has = g_m > _mass_floor(scene, g_m)
    safe = jnp.where(has, g_m, 1.0)
    v0x = jnp.where(has, gridsum[..., 0] / safe, 0.0)      # pre-force
    v0y = jnp.where(has, gridsum[..., 1] / safe, 0.0)
    grav = np.asarray(cfg.gravity_acceleration(scene.physics), np.float32)
    low0, high0, low1, high1 = _axis_bands2d(
        cfg, gridsum.shape[0], gridsum.shape[1], row_index0
    )
    if cfg.surface_tension > 0.0:
        # CSF surface tension on the fast path's (R, G) mass plane — same
        # grid-side force as the general path (stabilized._csf_force is
        # dim-agnostic); sharded slabs reuse the gather-only halo refresh
        # (VERDICT r3 item 5).  Momentum increment dt * F/V * (m/rho),
        # added to the momentum sums BEFORE the mass solve + wall BC,
        # matching the general path's rhs ordering.
        from mpm_flip98a_tpu.models.stabilized import GridContext, _csf_force

        csf_ctx = None
        if domain is not None:
            csf_ctx = GridContext(
                node_shape=None, cell_shape=None,
                axis=domain.axis, halo_exchange=domain.halo_gather_only,
            )
        f_st = _csf_force(g_m, cfg, scene.physics, jnp.float32, csf_ctx)
        st_scale = dt * g_m / jnp.float32(scene.physics.particle_density)
        st_x = f_st[..., 0] * st_scale
        st_y = f_st[..., 1] * st_scale
    else:
        st_x = st_y = None
    if cfg.use_penalty_ebc:
        # Implicit normal-velocity penalty (same formulation as the general
        # path, models/stabilized.py): (m I + dt beta n(x)n) v = m v* + dt m g;
        # the box's penalty matrix is diagonal, so the solve is a divide.
        # The diagonal per channel a is just the axis-a wall band mask.
        beta = jnp.float32(cfg.penalty_parameter(scene.physics))
        pen0 = (low0 | high0).astype(jnp.float32)
        pen1 = (low1 | high1).astype(jnp.float32)
        rhs_x = gridsum[..., 2] + (dt * grav[0]) * g_m
        rhs_y = gridsum[..., 3] + (dt * grav[1]) * g_m
        if st_x is not None:
            rhs_x = rhs_x + st_x
            rhs_y = rhs_y + st_y
        vx = jnp.where(has, rhs_x / (g_m + (dt * beta) * pen0), 0.0)
        vy = jnp.where(has, rhs_y / (g_m + (dt * beta) * pen1), 0.0)
    else:
        hasf = has.astype(jnp.float32)
        vx = jnp.where(has, gridsum[..., 2] / safe, 0.0) + (dt * grav[0]) * hasf
        vy = jnp.where(has, gridsum[..., 3] / safe, 0.0) + (dt * grav[1]) * hasf
        if st_x is not None:
            # (mv + dt F m/rho)/m == mv/m + (dt F m/rho)/m: identical to
            # the general path's rhs form, and bitwise a no-op when off.
            vx = vx + jnp.where(has, st_x / safe, 0.0)
            vy = vy + jnp.where(has, st_y / safe, 0.0)
        # Slip/sticky walls, semantics of models/stabilized._apply_wall_bc:
        # slip clamps the outgoing normal component per axis band.
        if scene.wall.kind == "sticky":
            anyband = low0 | high0 | low1 | high1
            vx = jnp.where(anyband, 0.0, vx)
            vy = jnp.where(anyband, 0.0, vy)
        else:
            vx = jnp.where(low0, jnp.maximum(vx, 0.0), vx)
            vx = jnp.where(high0, jnp.minimum(vx, 0.0), vx)
            vy = jnp.where(low1, jnp.maximum(vy, 0.0), vy)
            vy = jnp.where(high1, jnp.minimum(vy, 0.0), vy)
    col_solid = None
    if scene.colliders:
        # EXTENSION: rigid SDF colliders (models/colliders.py) on the
        # (R, G) planes — pointwise, so sharded slabs just pass global
        # row indices.  Same placement as the general path: after the
        # wall/penalty BC, before any grid-side solve.
        from mpm_flip98a_tpu.models import colliders as _col

        idx0 = (
            jnp.arange(gridsum.shape[0]) if row_index0 is None else row_index0
        )[:, None]
        idx1 = jnp.arange(gridsum.shape[1])[None, :]
        coords = _col.node_coords(cfg, [idx0, idx1])
        vx, vy = _col.project([vx, vy], coords, scene.colliders, t)
        col_solid = _col.inside_any(coords, scene.colliders, t)
    if cfg.incompressible:
        # Chorin projection on the fast path's (R, G) velocity planes —
        # consumes only grid data the fast path already owns (VERDICT r3
        # item 4).  Sharded slabs: psum dots + gather-only halo refresh
        # per CG iteration, owned rows [1, 1 + L) of the (L + 4, G)
        # fold buffer (H_LO = 1 below, H_HI = 3 above).
        from mpm_flip98a_tpu.models import projection as _proj

        own = None
        halo = None
        ax = None
        if domain is not None:
            rr = gridsum.shape[0]
            rows_idx = jnp.arange(rr)
            own = (rows_idx >= 1) & (rows_idx < rr - 3)
            halo = domain.halo_gather_only
            ax = domain.axis
        floor = _mass_floor(scene, g_m)
        if ax is not None and scene.mass_floor <= 0.0:
            # The relative floor uses the shard-LOCAL max — pmax it so
            # halo rows classify fluid/air identically on both owners.
            floor = jax.lax.pmax(floor, ax)
        (vx, vy), _, _ = _proj.project_planes(
            (vx, vy), g_m, floor,
            dx=float(cfg.dx), lo=int(PAD), hi=cfg.num_grids - 1 - int(PAD),
            iters=int(cfg.pressure_iters), tol=float(cfg.pressure_tol),
            row_index0=row_index0, axis=ax, halo=halo, own=own,
            solid_extra=col_solid,
        )
    gch = [vx, vy, v0x, v0y]
    if ext:
        # Nodal averages for the NEXT substep's stress: Jbar, p, div.
        v0sum = gridsum[..., 6]
        has_v = v0sum > 0
        safe_v = jnp.where(has_v, v0sum, 1.0)
        gch.append(jnp.where(has_v, gridsum[..., 5] / safe_v, 1.0))
        gch.append(jnp.where(has_v, gridsum[..., 7] / safe_v, 0.0))
        gch.append(jnp.where(has_v, gridsum[..., 8] / safe_v, 0.0))
    return jnp.stack(gch, axis=-1)  # (R, G, 4 or 7)


def substep(
    b: FluidBuckets, scene: Scene, grid_reduce=None, domain=None, t=None
) -> FluidBuckets:
    """One fast substep; numerics mirror models/stabilized.py substep_grid
    restricted to the fluid feature set.

    `domain` (parallel/fast_domain.FastDomainCtx) runs the same physics on
    a slab shard: bucket rows are a LOCAL window of the global grid, the
    P2G edge rows ride a halo exchange instead of being cropped, and the
    wall masks use global row indices.  `t` (traced scalar, simulation
    seconds) advects kinematic colliders."""
    cfg = scene.cfg
    assert cfg.dim == 2
    g = kernel_cols(cfg)  # grid-plane column width
    dt = jnp.float32(cfg.dt)
    dx = float(cfg.dx)
    inv_dx = jnp.float32(cfg.inv_dx)
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    r, k = b.shape

    gx0 = b.x0 * inv_dx + jnp.float32(PAD)
    gx1 = b.x1 * inv_dx + jnp.float32(PAD)
    if g < cfg.num_grids:
        # Cropped width (see kernel_cols): pin the column transfer
        # coordinate inside the tap-safe band so no stencil tap can land
        # on the dropped last column.  Identity for every particle that
        # has not penetrated half a cell past the wall-band node line.
        gx1 = jnp.minimum(
            gx1, jnp.float32(cfg.num_grids - 1 - PAD + 0.49)
        )
    if domain is not None:
        # Row coordinates are local to the slab: bucket row i holds
        # particles with global base row ~ lo + i, and buffer row j of
        # the (L + 4)-row halo layout is local target row j - 1.
        lo = jax.lax.axis_index(domain.axis) * r
        gx0 = gx0 - lo.astype(jnp.float32)
        row_index0 = lo - 1 + jnp.arange(r + 4)
        grid_shape = (r + 4, g)
        shift = (1, 0)
    else:
        row_index0 = None
        grid_shape = (r, g)
        shift = None

    apic = cfg.transfer == TransferKind.APIC
    ratio = float(cfg.pressure_mixing_ratio)
    ext = bool(cfg.use_fbar or ratio > 0.0)

    # ---- stress: component-form material dispatch ----------------------
    # Same models as models/materials.py, written on (R, K) component
    # arrays (building (R, K, 2, 2) temporaries would tile terribly).
    #
    # Fused stabilization (F-bar / pressure mixing): the nodal averages
    # jbar_s / p_s / div_s were gathered by LAST substep's G2P (extra grid
    # channels) — a one-substep lag relative to the general path's
    # separate projection pass, consistent explicit integration.
    # Semi-implicit lag correction: the nodal averages are one substep
    # stale, and that pure delay destabilises the acoustic feedback when
    # BOTH stabilizers are active (measured: stable CFL halves).  Advance
    # each average by its known local rate over the lag interval —
    # dJ/dt = J div(v), with div(v) = tr C from the latest gather — which
    # removes the O(dt) phase error and restores the full stability
    # region (scripts/exp_fused_dt.py).  At t = 0 div = 0, so the
    # first-substep exactness vs the general path is preserved.
    div_lag = b.C00 + b.C11
    jbar_adv = b.jbar_s * (1.0 + dt * div_lag) if ext else b.jbar_s
    jeff = jbar_adv if cfg.use_fbar else b.J
    vj = b.vol0 * jeff
    p_point_out = jnp.zeros_like(b.J)
    tau00 = jnp.zeros_like(b.J)
    tau01 = jnp.zeros_like(b.J)
    tau10 = jnp.zeros_like(b.J)
    tau11 = jnp.zeros_like(b.J)
    for mid in scene.materials_present:
        if mid == mat.WEAKLY_COMPRESSIBLE_FLUID:
            kb = jnp.float32(scene.params.bulk_modulus)
            mu = jnp.float32(scene.params.dynamic_viscosity)
            if scene.params.eos == EOSKind.LINEAR:
                p_point = -kb * (jeff - 1.0)
            else:
                gamma = jnp.float32(scene.params.tait_gamma)
                # Guard the power against degenerate J (belt to the dead-slot
                # neutral-fill suspenders in _safe_dead_slots).
                j_safe = jnp.maximum(jeff, jnp.float32(1e-3))
                p_point = (kb / gamma) * ((1.0 / j_safe) ** gamma - 1.0)
            p_point_out = p_point
            if ratio > 0.0:
                # Lag correction for the projected pressure: dp/dt =
                # dp/dJ * J * div with dp/dJ from the EOS at jeff.
                if scene.params.eos == EOSKind.LINEAR:
                    dp_dt = -kb * jeff * div_lag
                else:
                    dp_dt = -kb * (1.0 / j_safe) ** gamma * div_lag
                pressure = ratio * (b.p_s + dt * dp_dt) + (1.0 - ratio) * p_point
            else:
                pressure = p_point
            div = b.C00 + b.C11
            t00 = vj * (-pressure + 2.0 * mu * (b.C00 - 0.5 * div))
            t11 = vj * (-pressure + 2.0 * mu * (b.C11 - 0.5 * div))
            t01 = vj * (2.0 * mu * 0.5 * (b.C01 + b.C10))
            t10 = t01
        elif mid == mat.SAND:
            # Drucker-Prager sand (materials.sand_tau_hat) on stacked
            # (R, K, 2, 2) matrices: the SVD-based Hencky stress has
            # no cheap component form, and sand is not the headline
            # bench path — correctness over layout.  Dead slots sit
            # at F = I (eps = 0, tau = 0), so no masking needed.
            fm_s = jnp.stack(
                [jnp.stack([b.F00, b.F01], -1),
                 jnp.stack([b.F10, b.F11], -1)], -2
            )
            tm_s = mat.sand_tau_hat(scene.params, b.vol0, fm_s)
            t00, t01 = tm_s[..., 0, 0], tm_s[..., 0, 1]
            t10, t11 = tm_s[..., 1, 0], tm_s[..., 1, 1]
            # tau = V0 (mu_s (F F^T - I) + lam_s log(Jf) I)
            mu_s = jnp.float32(scene.params.mu)
            lam_s = jnp.float32(scene.params.lam)
            jf = jnp.maximum(
                b.F00 * b.F11 - b.F01 * b.F10, jnp.float32(1e-6)
            )
            lj = lam_s * jnp.log(jf)
            t00 = b.vol0 * (mu_s * (b.F00**2 + b.F01**2 - 1.0) + lj)
            t11 = b.vol0 * (mu_s * (b.F10**2 + b.F11**2 - 1.0) + lj)
            t01 = b.vol0 * mu_s * (b.F00 * b.F10 + b.F01 * b.F11)
            t10 = t01
        else:  # FIXED_COROTATED / SNOW: V0 (2 mu (F-R) F^T + lam (Jf-1) Jf I)
            mu_s = jnp.float32(scene.params.mu)
            lam_s = jnp.float32(scene.params.lam)
            if mid == mat.SNOW:
                # Hardening-scaled Lame parameters from the tracked
                # plastic volume (mls-mpm88-explained.cpp:67-69).
                h = jnp.exp(
                    jnp.float32(scene.params.hardening) * (1.0 - b.Jp)
                )
                mu_s = mu_s * h
                lam_s = lam_s * h
            jf = b.F00 * b.F11 - b.F01 * b.F10
            px = b.F00 + b.F11
            py = b.F10 - b.F01
            # max() guards the polar normalisation against degenerate F
            # (F = 0 only happens in unfixed dead slots, but a collapsed
            # active F would hit the same 1/0).
            sc = 1.0 / jnp.sqrt(jnp.maximum(px * px + py * py, jnp.float32(1e-12)))
            rc, rs = px * sc, py * sc
            d00, d01 = b.F00 - rc, b.F01 + rs
            d10, d11 = b.F10 - rs, b.F11 - rc
            lj = lam_s * (jf - 1.0) * jf
            t00 = b.vol0 * (2 * mu_s * (d00 * b.F00 + d01 * b.F01) + lj)
            t01 = b.vol0 * (2 * mu_s * (d00 * b.F10 + d01 * b.F11))
            t10 = b.vol0 * (2 * mu_s * (d10 * b.F00 + d11 * b.F01))
            t11 = b.vol0 * (2 * mu_s * (d10 * b.F10 + d11 * b.F11) + lj)
        if len(scene.materials_present) == 1:
            tau00, tau01, tau10, tau11 = t00, t01, t10, t11
        else:
            sel = b.mat == mid
            tau00 = jnp.where(sel, t00, tau00)
            tau01 = jnp.where(sel, t01, tau01)
            tau10 = jnp.where(sel, t10, tau10)
            tau11 = jnp.where(sel, t11, tau11)

    # ---- P2G: one scatter-add of the 9 stencil taps per slot ------------
    # Channels [m v (2), m v + f (2), m] (+ [V0 J, V0, V0 p, V0 div] for
    # the fused stabilization); the momentum channels carry the APIC / MLS
    # affine term, C for the pure pair (zero under PIC) and
    # C - dt Dinv tau / m for the forced pair.
    fa = -dt * jnp.float32(dinv)
    if apic:
        p_aff = ((b.mass * b.C00, b.mass * b.C01), (b.mass * b.C10, b.mass * b.C11))
        q_aff = tuple(
            tuple(pa + fa * ta for pa, ta in zip(p_aff[a], row))
            for a, row in enumerate(((tau00, tau01), (tau10, tau11)))
        )
    else:
        p_aff = (None, None)
        q_aff = ((fa * tau00, fa * tau01), (fa * tau10, fa * tau11))
    mv0, mv1 = b.mass * b.v0, b.mass * b.v1
    channels = [mv0, mv1, mv0, mv1, b.mass]
    affine = [p_aff[0], p_aff[1], q_aff[0], q_aff[1], None]
    if ext:
        div_point = b.C00 + b.C11
        channels += [
            b.vol0 * b.J, b.vol0, b.vol0 * p_point_out, b.vol0 * div_point
        ]
        affine += [None] * 4
    st = transfer.slot_stencil((gx0, gx1), b.mask > 0, cfg.kernel, shift)
    gridsum = transfer.p2g_slots(st, channels, affine, grid_shape, dx)
    if domain is not None:
        # Slab shard: the edge rows trade with the neighbor shards (reduce
        # partial sums in, gather completed rows back); the grid update
        # is then local.
        gridsum = domain.halo_sync(gridsum)
    if grid_reduce is not None:
        # Particle data parallelism: merge per-device partial grids
        # (parallel/fast_replicated.py passes a psum here).
        gridsum = grid_reduce(gridsum)
    grid4 = _grid_update2d(gridsum, scene, ext, row_index0, domain, t)

    # ---- G2P: gather the same 9 taps ------------------------------------
    sums, cm = transfer.g2p_slots(st, grid4, dx, cfg.kernel)
    sums = sums.reshape(r, k, -1)
    cm = cm.reshape(r, k, 2, 2)
    vpic0, vpic1 = sums[..., 0], sums[..., 1]
    vold0, vold1 = sums[..., 2], sums[..., 3]
    c00, c01, c10, c11 = cm[..., 0, 0], cm[..., 0, 1], cm[..., 1, 0], cm[..., 1, 1]

    alpha = jnp.float32(cfg.flip_blend)
    nv0 = alpha * (b.v0 + vpic0 - vold0) + (1 - alpha) * vpic0
    nv1 = alpha * (b.v1 + vpic1 - vold1) + (1 - alpha) * vpic1

    div_new = c00 + c11
    if ratio > 0.0:
        # Mixed divergence drives the volumetric update (the general path's
        # pressureMixingRatio semantics with the same one-substep lag).
        div_for_j = ratio * b.div_s + (1.0 - ratio) * div_new
    else:
        div_for_j = div_new
    if ext:
        jbar_new = jnp.where(b.mask > 0, sums[..., 4], 1.0)
        p_new = sums[..., 5] * b.mask
        div_s_new = sums[..., 6] * b.mask
    else:
        jbar_new = b.jbar_s
        p_new = b.p_s
        div_s_new = b.div_s
    # F <- (I + dt C) F, component form (mls-mpm88-explained.cpp:162).
    f00 = (1 + dt * c00) * b.F00 + dt * c01 * b.F10
    f01 = (1 + dt * c00) * b.F01 + dt * c01 * b.F11
    f10 = dt * c10 * b.F00 + (1 + dt * c11) * b.F10
    f11 = dt * c10 * b.F01 + (1 + dt * c11) * b.F11
    jp_new = b.Jp
    if (scene.params.plastic and mat.FIXED_COROTATED in scene.materials_present) \
            or mat.SNOW in scene.materials_present \
            or mat.SAND in scene.materials_present:
        # Snow-plasticity singular-value clamp + Jp tracking
        # (mls-mpm88:164-177) / sand Drucker-Prager cone projection.
        # Dead slots are parked at F = I, Jp = 1, which both leave
        # unchanged.
        fm = jnp.stack(
            [jnp.stack([f00, f01], -1), jnp.stack([f10, f11], -1)], -2
        )
        fm, jp_new = mat.plastic_update(
            scene.params, b.mat, fm, b.Jp, scene.materials_present
        )
        f00, f01 = fm[..., 0, 0], fm[..., 0, 1]
        f10, f11 = fm[..., 1, 0], fm[..., 1, 1]
    return FluidBuckets(
        x0=b.x0 + dt * vpic0 * b.mask,
        x1=b.x1 + dt * vpic1 * b.mask,
        v0=nv0 * b.mask,
        v1=nv1 * b.mask,
        C00=c00, C01=c01, C10=c10, C11=c11,
        F00=f00, F01=f01, F10=f10, F11=f11,
        J=jnp.where(b.mask > 0, b.J * (1.0 + dt * div_for_j), 1.0),
        mass=b.mass,
        vol0=b.vol0,
        mat=b.mat,
        Jp=jp_new,
        jbar_s=jbar_new,
        p_s=p_new,
        div_s=div_s_new,
        mask=b.mask,
        overflow=b.overflow,
    )


def _needs_rebucket(b: FluidBuckets, cfg: MPMConfig, row0=0) -> jax.Array:
    """True when any active slot approaches the +-1-row bucket margin.

    Post-rebucket every slot has gx0 - 0.5 - bucket_row in [0, 1); the
    slab halo window stays exact while it remains in [-1, 2).  Trigger with a 0.2-row
    safety band so the check (cheap elementwise max, every substep) always
    fires before the margin is violated.  `row0` is the global row of
    bucket 0 on a slab shard (parallel/fast_domain.py)."""
    r, k = b.shape
    gx0 = b.x0 * jnp.float32(cfg.inv_dx) + jnp.float32(PAD)
    rows = row0 + jax.lax.broadcasted_iota(jnp.int32, (r, k), 0)
    d = gx0 - 0.5 - rows.astype(jnp.float32)
    d = jnp.where(b.mask > 0, d, 0.5)
    return jnp.any((d <= -0.8) | (d >= 1.8))


@partial(jax.jit, static_argnames=("scene", "spec", "n_substeps"))
def run(
    b: FluidBuckets, scene: Scene, spec: FastSpec, n_substeps: int, t0=None
) -> FluidBuckets:
    """Advance n_substeps on-device with adaptive rebucketing.

    Rebucketing is a global sort + gather pass, so it runs only when the
    drift check says the one-row margin is at risk — every few hundred
    substeps at CFL-respecting dt.

    `t0` (traced scalar, simulation seconds at entry) drives kinematic
    colliders; substep i sees t = t0 + i dt.  None, or a scene with no
    moving collider, keeps the loop body time-free."""
    from mpm_flip98a_tpu.models import colliders as _col

    moving = (
        t0 is not None
        and scene.colliders
        and _col.any_moving(scene.colliders)
    )

    if _os.environ.get("MPM_RUN_WHILE", "1") == "1":
        # Default: hoist the per-substep lax.cond on the full bucket
        # state out of the hot body.  An inner while_loop advances while
        # the margin check passes (the check is the loop predicate — same
        # every-substep semantics, rebucket still happens BEFORE the
        # first unsafe substep), and rebucket runs only at inner-loop
        # exit.  Bit-exact vs fori+cond (tests/test_fast2d.py);
        # MPM_RUN_WHILE=0 re-selects fori+cond.
        # The margin flag rides the CARRY: the body computes it on its
        # own output (fusable with the particle update — same x reads),
        # so the while predicate only reads a carried scalar.  A
        # predicate that recomputes the check is a separate XLA
        # computation between iterations and cannot fuse with the body.
        # Semantics are unchanged: the flag is evaluated on exactly the
        # same states as before, one loop-carry earlier — a substep
        # never reads a state outside the margin band.
        def inner_cond(c):
            j, s, flag = c
            return jnp.logical_and(j < n_substeps, ~flag)

        def inner_body(c):
            j, s, _ = c
            t = jnp.asarray(t0) + j * scene.cfg.dt if moving else None
            s = substep(s, scene, t=t)
            return j + 1, s, _needs_rebucket(s, scene.cfg)

        def outer_cond(c):
            j, _, _ = c
            return j < n_substeps

        def outer_body(c):
            j, s, flag = c
            j, s, flag = jax.lax.while_loop(
                inner_cond, inner_body, (j, s, flag)
            )

            def fix(q):
                # Rebucket + one substep: guarantees outer-loop progress
                # even if the margin check somehow still fires after the
                # rebucket (matches the fori variant, which substeps
                # unconditionally after its cond).
                q = rebucket(q, scene.cfg, spec)
                t = jnp.asarray(t0) + j * scene.cfg.dt if moving else None
                q = substep(q, scene, t=t)
                return q, _needs_rebucket(q, scene.cfg)

            s, flag = jax.lax.cond(
                j < n_substeps, fix, lambda q: (q, flag), s
            )
            j = jnp.minimum(j + 1, n_substeps)
            return j, s, flag

        return jax.lax.while_loop(
            outer_cond, outer_body,
            (0, b, _needs_rebucket(b, scene.cfg)),
        )[1]

    def body(i, st):
        st = jax.lax.cond(
            _needs_rebucket(st, scene.cfg),
            lambda s: rebucket(s, scene.cfg, spec),
            lambda s: s,
            st,
        )
        t = jnp.asarray(t0) + i * scene.cfg.dt if moving else None
        return substep(st, scene, t=t)

    return jax.lax.fori_loop(0, n_substeps, body, b)
