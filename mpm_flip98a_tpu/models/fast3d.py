"""Fast 3D solver: the pencil-bucketed production path.

3D counterpart of models/fast2d.py for the BASELINE.json configs[3]
workload (3D free-surface flow, 8M particles, 256^3 grid, quadratic
B-spline transfers).  Particles live in (R0 x R1, K) pencil buckets — one
bucket per (x, y) grid line — and transfer through one XLA scatter-add
and one gather over the slots (ops/transfer.p2g_slots / g2p_slots);
rebucketing is adaptive on the two bucketed axes exactly like the 2D
path.

Feature switches covered (round 2, mirroring fast2d.py): APIC/PIC
transfer, FLIP blend, linear/Tait EOS, slip/sticky walls, penalty EBC,
fused F-bar / pressure-mixing stabilization with the semi-implicit lag
correction, and multi-material dispatch (weakly-compressible fluid,
neo-Hookean, fixed corotated with a component-form scaled-Newton polar
matching ops/mathx.polar_decomp_3d), and the tent kernel.
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
class FluidBuckets3D:
    """Pencil-bucketed 3D state; every field (R0 * R1, K) f32 (mat int32)."""

    x0: jax.Array
    x1: jax.Array
    x2: jax.Array
    v0: jax.Array
    v1: jax.Array
    v2: jax.Array
    C00: jax.Array
    C01: jax.Array
    C02: jax.Array
    C10: jax.Array
    C11: jax.Array
    C12: jax.Array
    C20: jax.Array
    C21: jax.Array
    C22: jax.Array
    F00: jax.Array
    F01: jax.Array
    F02: jax.Array
    F10: jax.Array
    F11: jax.Array
    F12: jax.Array
    F20: jax.Array
    F21: jax.Array
    F22: jax.Array
    J: jax.Array
    mass: jax.Array
    vol0: jax.Array
    mat: jax.Array       # int32 material id (models/materials.py)
    Jp: jax.Array        # plastic volume ratio (SNOW hardening state)
    # Fused-stabilization state (lag-corrected nodal averages; only
    # meaningful when use_fbar / pressure mixing is on):
    jbar_s: jax.Array
    p_s: jax.Array
    div_s: jax.Array
    mask: jax.Array
    overflow: jax.Array

    @property
    def shape(self) -> Tuple[int, int]:
        return self.x0.shape


@dataclasses.dataclass(frozen=True)
class FastSpec3D:
    rows0: int
    rows1: int
    capacity: int

    @staticmethod
    def for_particles(cfg: MPMConfig, p: Particles, headroom: float = None) -> "FastSpec3D":
        g = cfg.num_grids
        x = np.asarray(p.x)
        r0 = np.floor(x[:, 0] * cfg.inv_dx + PAD - 0.5).astype(np.int64)
        r1 = np.floor(x[:, 1] * cfg.inv_dx + PAD - 0.5).astype(np.int64)
        pair = np.clip(r0, 0, g - 1) * g + np.clip(r1, 0, g - 1)
        occ = int(np.bincount(pair, minlength=g * g).max())
        return FastSpec3D(rows0=g, rows1=g, capacity=capacity_for(occ, headroom))


def capacity_for(occ: int, headroom: float = None) -> int:
    """Pencil-bucket capacity for a peak occupancy: headroom-padded and
    rounded up to a multiple of 128 slots (see fast2d.capacity_for;
    MPM_HEADROOM overrides the default 1.5)."""
    if headroom is None:
        headroom = float(_os.environ.get("MPM_HEADROOM", "1.5"))
    return max(128, -(-int(headroom * occ) // 128) * 128)


def _field_list(b: FluidBuckets3D):
    return (
        b.x0, b.x1, b.x2, b.v0, b.v1, b.v2,
        b.C00, b.C01, b.C02, b.C10, b.C11, b.C12, b.C20, b.C21, b.C22,
        b.F00, b.F01, b.F02, b.F10, b.F11, b.F12, b.F20, b.F21, b.F22,
        b.J, b.mass, b.vol0, b.mat, b.Jp,
        b.jbar_s, b.p_s, b.div_s,
    )


def _pair_row(x0, x1, cfg: MPMConfig, spec: FastSpec3D):
    gx0 = x0 * cfg.inv_dx + PAD
    gx1 = x1 * cfg.inv_dx + PAD
    r0 = jnp.floor(gx0 - 0.5).astype(jnp.int32)
    r1 = jnp.floor(gx1 - 0.5).astype(jnp.int32)
    return jnp.clip(r0, 0, spec.rows0 - 1) * spec.rows1 + jnp.clip(
        r1, 0, spec.rows1 - 1
    )


def _safe_dead_slots(b: FluidBuckets3D) -> FluidBuckets3D:
    """Neutral-fill inactive slots (J = 1, F = I): bucket_by_row zero-fills
    them, and zeros blow up the Tait 1/J power and the corotated polar into
    inf -> masked NaN (0 * inf)."""
    on = b.mask > 0
    one = lambda a: jnp.where(on, a, jnp.ones_like(a))
    return dataclasses.replace(
        b, J=one(b.J), F00=one(b.F00), F11=one(b.F11), F22=one(b.F22),
        Jp=one(b.Jp), jbar_s=one(b.jbar_s),
    )


def rebucket(b: FluidBuckets3D, cfg: MPMConfig, spec: FastSpec3D) -> FluidBuckets3D:
    flat = tuple(f.reshape(-1) for f in _field_list(b))
    mask = b.mask.reshape(-1) > 0
    row = _pair_row(flat[0], flat[1], cfg, spec)
    fields, new_mask, overflow = binning.bucket_by_row(
        row, mask, flat, spec.rows0 * spec.rows1, spec.capacity
    )
    return _safe_dead_slots(
        FluidBuckets3D(
            *fields, mask=new_mask.astype(jnp.float32), overflow=b.overflow + overflow
        )
    )


def from_particles(p: Particles, cfg: MPMConfig, spec: FastSpec3D) -> FluidBuckets3D:
    to32 = lambda a: jnp.asarray(a, jnp.float32)
    x = to32(p.x)
    v = to32(p.v)
    c = to32(p.C)
    f = to32(p.F)
    n = p.n
    flat = (
        x[:, 0], x[:, 1], x[:, 2], v[:, 0], v[:, 1], v[:, 2],
        *(c[:, a, b2] for a in range(3) for b2 in range(3)),
        *(f[:, a, b2] for a in range(3) for b2 in range(3)),
        to32(p.J), to32(p.mass), to32(p.volume0),
        p.material.astype(jnp.int32),
        to32(p.Jp),
        to32(p.J),                      # jbar_s init = J
        jnp.zeros((n,), jnp.float32),   # p_s
        jnp.zeros((n,), jnp.float32),   # div_s
    )
    row = _pair_row(flat[0], flat[1], cfg, spec)
    fields, mask, overflow = binning.bucket_by_row(
        row, jnp.ones((n,), jnp.bool_), flat, spec.rows0 * spec.rows1, spec.capacity
    )
    return _safe_dead_slots(
        FluidBuckets3D(*fields, mask=mask.astype(jnp.float32), overflow=overflow)
    )


def to_host(b: FluidBuckets3D) -> dict:
    """One gathered device_get — see fast2d.to_host."""
    names = ("x0", "x1", "x2", "v0", "v1", "v2", "J", "mass", "mat", "Jp")
    arrs = jax.device_get([b.mask] + [getattr(b, n) for n in names])
    mask = arrs[0] > 0
    return {n: a[mask] for n, a in zip(names, arrs[1:])}


def _polar3d_rows(F, iters: int = 12):
    """Component-form 3D polar rotation factor (same scaled Newton
    iteration as ops/mathx.polar_decomp_3d, on (S, K) component arrays —
    the component lists keep every array slot-shaped).  F is a 9-list [F00..F22]; returns the 9-list R."""
    r = list(F)

    def cof(m):
        # Cofactor matrix (row-major 9-list): cof[3a+c] = d inv-transpose.
        c = [None] * 9
        c[0] = m[4] * m[8] - m[5] * m[7]
        c[1] = m[5] * m[6] - m[3] * m[8]
        c[2] = m[3] * m[7] - m[4] * m[6]
        c[3] = m[2] * m[7] - m[1] * m[8]
        c[4] = m[0] * m[8] - m[2] * m[6]
        c[5] = m[1] * m[6] - m[0] * m[7]
        c[6] = m[1] * m[5] - m[2] * m[4]
        c[7] = m[2] * m[3] - m[0] * m[5]
        c[8] = m[0] * m[4] - m[1] * m[3]
        return c

    tiny = jnp.float32(np.finfo(np.float32).tiny)
    for _ in range(iters):
        c = cof(r)
        det = r[0] * c[0] + r[1] * c[1] + r[2] * c[2]
        inv_det = 1.0 / jnp.where(jnp.abs(det) > tiny, det, 1.0)
        rit = [ci * inv_det for ci in c]  # R^{-T} = cof(R) / det
        a = sum(x * x for x in rit)
        bb = sum(x * x for x in r)
        gamma = jnp.sqrt(jnp.sqrt(a / jnp.maximum(bb, tiny)))
        inv_g = 1.0 / gamma
        r = [0.5 * (gamma * r[i] + inv_g * rit[i]) for i in range(9)]
    return r


def _grid_update(
    gs: jax.Array, scene: Scene, ext: bool, row_index0=None, row_index1=None,
    domain=None, t=None,
) -> jax.Array:
    """Grid momentum update on the channel-last (G0, G1, G2, nch) P2G sums;
    returns the (G0, G1, G2, gch) grid that G2P gathers."""
    cfg = scene.cfg
    dt = jnp.float32(cfg.dt)
    grid_shape = gs.shape[:3]
    g_m = gs[..., 6]                               # (G0, G1, G2)
    # Mass floor: knife-edge stencil taps (fx within 1 ulp of a tap
    # boundary) deposit ~1e-15 x a particle mass on isolated nodes;
    # momentum/mass there is pure fp noise that the velocity update turns
    # into O(1) junk kicks.  A node carrying < 1e-8 of the heaviest node
    # is dynamically meaningless — treat it as empty.  Absolute floor
    # (scene.mass_floor) when available: shard-invariant under shard_map
    # (the relative fallback uses the shard-LOCAL max, so neighboring
    # shards could disagree on `has` for shared halo rows).
    from mpm_flip98a_tpu.models.stabilized import (
        _apply_wall_bc,
        _mass_floor,
        _wall_normal_diag,
    )

    has = g_m > _mass_floor(scene, g_m)
    safe = jnp.where(has, g_m, 1.0)[..., None]
    hc = has[..., None]
    v0g = jnp.where(hc, gs[..., 0:3] / safe, 0.0)
    grav = jnp.asarray(cfg.gravity_acceleration(scene.physics), jnp.float32)
    # Sharded grid-side extension hooks (CSF / projection): gather-only
    # halo refresh + psum axes + owned-row masks.  Mirrors fast2d.
    ext_axis = ext_halo = ext_own = None
    if domain is not None and (cfg.surface_tension > 0.0 or cfg.incompressible):
        rr0 = gs.shape[0]
        own0 = (jnp.arange(rr0) >= 1) & (jnp.arange(rr0) < rr0 - 3)
        if getattr(domain, "axis1", None) is not None:
            rr1 = gs.shape[1]
            own1 = (jnp.arange(rr1) >= 1) & (jnp.arange(rr1) < rr1 - 3)
            ext_own = own0[:, None, None] & own1[None, :, None]
            ext_axis = (domain.axis0, domain.axis1)
        else:
            ext_own = own0
            ext_axis = (domain.axis0,)
        ext_halo = domain.halo_gather_only
    if cfg.surface_tension > 0.0:
        # CSF surface tension on the (G0, G1, G2) nodal mass field — the
        # same grid-side force as the general path (stabilized._csf_force
        # is dim-agnostic).
        from mpm_flip98a_tpu.models.stabilized import GridContext, _csf_force

        csf_ctx = None
        if domain is not None:
            csf_ctx = GridContext(
                node_shape=None, cell_shape=None,
                axis=ext_axis, halo_exchange=ext_halo,
            )
        f_st = _csf_force(g_m, cfg, scene.physics, jnp.float32, csf_ctx)
        st = f_st * (dt * g_m / jnp.float32(scene.physics.particle_density))[..., None]
    else:
        st = None
    if cfg.use_penalty_ebc:
        # Implicit normal-velocity penalty, diagonal for the axis-aligned
        # box (same formulation as models/stabilized.py / fast2d.py).
        beta = jnp.float32(cfg.penalty_parameter(scene.physics))
        pen = _wall_normal_diag(
            cfg, jnp.float32, grid_shape, row_index0, row_index1
        )
        rhs = gs[..., 3:6] + dt * g_m[..., None] * grav
        if st is not None:
            rhs = rhs + st
        v_new = jnp.where(hc, rhs / (g_m[..., None] + dt * beta * pen), 0.0)
    else:
        vng = jnp.where(hc, gs[..., 3:6] / safe, 0.0)
        vng = vng + dt * grav * hc.astype(jnp.float32)
        if st is not None:
            # (mv + dt F m/rho)/m == mv/m + st/m: the general path's rhs
            # form, bitwise a no-op when surface tension is off.
            vng = vng + jnp.where(hc, st / safe, 0.0)
        v_new = _apply_wall_bc(
            vng, cfg, scene.wall, grid_shape, row_index0, row_index1
        )
    col_solid = None
    if scene.colliders:
        # EXTENSION: rigid SDF colliders (models/colliders.py) on the
        # (G0, G1, G2) component planes — pointwise; sharded windows pass
        # global row indices.  After the wall/penalty BC.
        from mpm_flip98a_tpu.models import colliders as _col

        g0, g1, g2 = grid_shape
        idx0 = (jnp.arange(g0) if row_index0 is None else row_index0)
        idx1 = (jnp.arange(g1) if row_index1 is None else row_index1)
        coords = _col.node_coords(
            cfg,
            [idx0[:, None, None], idx1[None, :, None], jnp.arange(g2)[None, None, :]],
        )
        comps = _col.project(
            [v_new[..., a] for a in range(3)], coords, scene.colliders, t
        )
        v_new = jnp.stack(comps, axis=-1)
        col_solid = _col.inside_any(coords, scene.colliders, t)
    if cfg.incompressible:
        # Chorin projection on the (G0, G1, G2) velocity planes between
        # grid update and G2P; sharded slabs/pencils run psum dots +
        # gather-only halo refresh per CG iteration.
        from mpm_flip98a_tpu.models import projection as _proj

        floor = _mass_floor(scene, g_m)
        if ext_axis is not None and scene.mass_floor <= 0.0:
            # Shard-invariant relative floor (pmax over the mesh axes) so
            # halo planes classify fluid/air identically on both owners.
            floor = jax.lax.pmax(floor, ext_axis)
        vs, _, _ = _proj.project_planes(
            tuple(v_new[..., a] for a in range(3)),
            g_m, floor,
            dx=float(cfg.dx), lo=int(PAD), hi=cfg.num_grids - 1 - int(PAD),
            iters=int(cfg.pressure_iters), tol=float(cfg.pressure_tol),
            row_index0=row_index0, row_index1=row_index1,
            axis=ext_axis, halo=ext_halo, own=ext_own,
            solid_extra=col_solid,
        )
        v_new = jnp.stack(vs, axis=-1)
    gparts = [v_new, v0g]
    if ext:
        v0sum = gs[..., 8:9]
        has_v = v0sum > 0
        safe_v = jnp.where(has_v, v0sum, 1.0)
        gparts += [
            jnp.where(has_v, gs[..., 7:8] / safe_v, 1.0),    # Jbar
            jnp.where(has_v, gs[..., 9:10] / safe_v, 0.0),   # p
            jnp.where(has_v, gs[..., 10:11] / safe_v, 0.0),  # div
        ]
    return jnp.concatenate(gparts, axis=-1)


def substep(
    b: FluidBuckets3D, scene: Scene, spec: FastSpec3D, domain=None, t=None
) -> FluidBuckets3D:
    """One fast 3D substep (same physics as fast2d.substep).

    `domain` (parallel/fast_domain3d.FastDomain3DCtx) runs it on a slab or
    block shard: the sharded axes use local bucket rows and an (L + 4)
    halo layout whose edge planes ride the halo exchange."""
    cfg = scene.cfg
    assert cfg.dim == 3
    g = cfg.num_grids
    r0, r1 = spec.rows0, spec.rows1
    k = spec.capacity
    dt = jnp.float32(cfg.dt)
    dx = float(cfg.dx)
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    apic = cfg.transfer == TransferKind.APIC
    invf, padf = jnp.float32(cfg.inv_dx), jnp.float32(PAD)
    gx0 = b.x0 * invf + padf
    gx1 = b.x1 * invf + padf
    gx2 = b.x2 * invf + padf
    grid_shape = [r0, r1, g]
    shift = [0, 0, 0]
    row_index0 = row_index1 = None
    if domain is not None:
        # Slab shard (parallel/fast_domain3d.py): axis-0 bucket rows are
        # local, and buffer row j of the (L0 + 4)-row halo layout is
        # local target row j - 1.  Two-axis decomposition (slabs x pencil
        # columns): axis 1 gets the same treatment.
        lo = jax.lax.axis_index(domain.axis0) * r0
        gx0 = gx0 - lo.astype(jnp.float32)
        row_index0 = lo - 1 + jnp.arange(r0 + 4)
        grid_shape[0], shift[0] = r0 + 4, 1
        if domain.axis1 is not None:
            lo1 = jax.lax.axis_index(domain.axis1) * r1
            gx1 = gx1 - lo1.astype(jnp.float32)
            row_index1 = lo1 - 1 + jnp.arange(r1 + 4)
            grid_shape[1], shift[1] = r1 + 4, 1

    cmat = [[getattr(b, f"C{a}{c}") for c in range(3)] for a in range(3)]
    fmat = [getattr(b, f"F{a}{c}") for a in range(3) for c in range(3)]
    div_lag = cmat[0][0] + cmat[1][1] + cmat[2][2]

    # ---- stress: component-form material dispatch (fast2d.py pattern) --
    ratio = float(cfg.pressure_mixing_ratio)
    ext = bool(cfg.use_fbar or ratio > 0.0)
    # Semi-implicit lag correction on the fused nodal averages (see
    # fast2d.substep: advance by the known local rates; div = tr C).
    jbar_adv = b.jbar_s * (1.0 + dt * div_lag) if ext else b.jbar_s
    jeff = jbar_adv if cfg.use_fbar else b.J
    vj = b.vol0 * jeff
    p_point_out = jnp.zeros_like(b.J)
    tau = [[jnp.zeros_like(b.J) for _ in range(3)] for _ in range(3)]
    for mid in scene.materials_present:
        # `tl` (NOT `t`): the simulation-time parameter `t` must survive
        # this loop — it feeds kinematic colliders in _grid_update below.
        tl = [[None] * 3 for _ in range(3)]
        if mid == mat.WEAKLY_COMPRESSIBLE_FLUID:
            kb = jnp.float32(scene.params.bulk_modulus)
            mu = jnp.float32(scene.params.dynamic_viscosity)
            if scene.params.eos == EOSKind.LINEAR:
                p_point = -kb * (jeff - 1.0)
            else:
                gamma = jnp.float32(scene.params.tait_gamma)
                j_safe = jnp.maximum(jeff, jnp.float32(1e-3))
                p_point = (kb / gamma) * ((1.0 / j_safe) ** gamma - 1.0)
            p_point_out = p_point
            if ratio > 0.0:
                if scene.params.eos == EOSKind.LINEAR:
                    dp_dt = -kb * jeff * div_lag
                else:
                    dp_dt = -kb * (1.0 / j_safe) ** gamma * div_lag
                pressure = ratio * (b.p_s + dt * dp_dt) + (1.0 - ratio) * p_point
            else:
                pressure = p_point
            for a in range(3):
                for c in range(3):
                    dev = 0.5 * (cmat[a][c] + cmat[c][a]) - (
                        div_lag / 3.0 if a == c else 0.0
                    )
                    tl[a][c] = vj * (
                        (-pressure if a == c else 0.0) + 2.0 * mu * dev
                    )
        elif mid == mat.SAND:
            # Drucker-Prager sand (materials.sand_tau_hat) on stacked
            # (..., 3, 3) matrices — the SVD-based Hencky stress has no
            # cheap component form; sand is not the headline bench path.
            # Dead slots sit at F = I (eps = 0, tau = 0).
            fm_s = jnp.stack(
                [jnp.stack(fmat[3 * a : 3 * a + 3], -1) for a in range(3)],
                -2,
            )
            tm_s = mat.sand_tau_hat(scene.params, b.vol0, fm_s)
            for a in range(3):
                for c in range(3):
                    tl[a][c] = tm_s[..., a, c]
        elif mid == mat.NEO_HOOKEAN:
            # tau = V0 (mu (F F^T - I) + lam log(Jf) I)
            mu_s = jnp.float32(scene.params.mu)
            lam_s = jnp.float32(scene.params.lam)
            jf = (
                fmat[0] * (fmat[4] * fmat[8] - fmat[5] * fmat[7])
                - fmat[1] * (fmat[3] * fmat[8] - fmat[5] * fmat[6])
                + fmat[2] * (fmat[3] * fmat[7] - fmat[4] * fmat[6])
            )
            lj = lam_s * jnp.log(jnp.maximum(jf, jnp.float32(1e-6)))
            for a in range(3):
                for c in range(3):
                    ffr = sum(fmat[3 * a + e] * fmat[3 * c + e] for e in range(3))
                    tl[a][c] = b.vol0 * (
                        mu_s * (ffr - (1.0 if a == c else 0.0))
                        + (lj if a == c else 0.0)
                    )
        else:  # FIXED_COROTATED / SNOW: V0 (2 mu (F-R) F^T + lam (Jf-1) Jf I)
            mu_s = jnp.float32(scene.params.mu)
            lam_s = jnp.float32(scene.params.lam)
            if mid == mat.SNOW:
                # Hardening-scaled Lame parameters from the tracked
                # plastic volume (mls-mpm88-explained.cpp:67-69).
                h = jnp.exp(jnp.float32(scene.params.hardening) * (1.0 - b.Jp))
                mu_s = mu_s * h
                lam_s = lam_s * h
            rrot = _polar3d_rows(fmat)
            jf = (
                fmat[0] * (fmat[4] * fmat[8] - fmat[5] * fmat[7])
                - fmat[1] * (fmat[3] * fmat[8] - fmat[5] * fmat[6])
                + fmat[2] * (fmat[3] * fmat[7] - fmat[4] * fmat[6])
            )
            lj = lam_s * (jf - 1.0) * jf
            for a in range(3):
                for c in range(3):
                    dfr = sum(
                        (fmat[3 * a + e] - rrot[3 * a + e]) * fmat[3 * c + e]
                        for e in range(3)
                    )
                    tl[a][c] = b.vol0 * (
                        2.0 * mu_s * dfr + (lj if a == c else 0.0)
                    )
        if len(scene.materials_present) == 1:
            tau = tl
        else:
            sel = b.mat == mid
            for a in range(3):
                for c in range(3):
                    tau[a][c] = jnp.where(sel, tl[a][c], tau[a][c])

    # ---- P2G: one scatter-add of the 27 stencil taps per slot -----------
    # Channels [m v (3), m v + f (3), m] (+ [V0 J, V0, V0 p, V0 div] for
    # the fused stabilization), affine terms as in fast2d.substep.
    fa = -dt * jnp.float32(dinv)
    mv = [b.mass * v for v in (b.v0, b.v1, b.v2)]
    if apic:
        p_aff = [tuple(b.mass * cmat[a][c] for c in range(3)) for a in range(3)]
    else:
        p_aff = [None] * 3
    q_aff = [
        tuple(
            (p_aff[a][c] if apic else 0.0) + fa * tau[a][c] for c in range(3)
        )
        for a in range(3)
    ]
    channels = mv + mv + [b.mass]
    affine = p_aff + q_aff + [None]
    if ext:
        channels += [
            b.vol0 * b.J, b.vol0, b.vol0 * p_point_out, b.vol0 * div_lag
        ]
        affine += [None] * 4
    st = transfer.slot_stencil((gx0, gx1, gx2), b.mask > 0, cfg.kernel, shift)
    gs = transfer.p2g_slots(st, channels, affine, tuple(grid_shape), dx)
    if domain is not None:
        gs = domain.halo_sync(gs)
    grid_ch = _grid_update(gs, scene, ext, row_index0, row_index1, domain, t)

    # ---- G2P: gather the same 27 taps -----------------------------------
    sums, cm = transfer.g2p_slots(st, grid_ch, dx, cfg.kernel)
    sums = sums.reshape(r0 * r1, k, -1)
    cm = cm.reshape(r0 * r1, k, 9)
    vpic = [sums[..., a] for a in range(3)]
    vold = [sums[..., 3 + a] for a in range(3)]
    c_new = [cm[..., i] for i in range(9)]

    alpha = jnp.float32(cfg.flip_blend)
    nv = [
        alpha * (vv + vp - vo) + (1 - alpha) * vp
        for vv, vp, vo in zip((b.v0, b.v1, b.v2), vpic, vold)
    ]
    div_new = c_new[0] + c_new[4] + c_new[8]
    if ratio > 0.0:
        div_for_j = ratio * b.div_s + (1.0 - ratio) * div_new
    else:
        div_for_j = div_new
    if ext:
        jbar_new = jnp.where(b.mask > 0, sums[..., 6], 1.0)
        p_new = sums[..., 7] * b.mask
        div_s_new = sums[..., 8] * b.mask
    else:
        jbar_new, p_new, div_s_new = b.jbar_s, b.p_s, b.div_s
    jp_new = b.Jp
    # F <- (I + dt C) F, component form.  Fluid stress never reads F (it
    # uses C and J), so fluid-only scenes skip the 9-field update entirely
    # (~2.4 GB/substep of dead traffic at 8M).
    if scene.materials_present == (mat.WEAKLY_COMPRESSIBLE_FLUID,):
        f_new = fmat
    else:
        f_new = [
            sum(
                ((1.0 if a == e else 0.0) + dt * c_new[3 * a + e]) * fmat[3 * e + c]
                for e in range(3)
            )
            for a in range(3)
            for c in range(3)
        ]
        if (scene.params.plastic and mat.FIXED_COROTATED in scene.materials_present) \
                or mat.SNOW in scene.materials_present \
                or mat.SAND in scene.materials_present:
            # Snow-plasticity singular-value clamp + Jp tracking
            # (mls-mpm88:164-177) / sand Drucker-Prager cone projection.
            # Dead slots are parked at F = I, Jp = 1, unchanged by both.
            fm = jnp.stack(
                [jnp.stack(f_new[3 * a : 3 * a + 3], -1) for a in range(3)], -2
            )
            fm, jp_new = mat.plastic_update(
                scene.params, b.mat, fm, jp_new, scene.materials_present
            )
            f_new = [fm[..., a, c] for a in range(3) for c in range(3)]
    return FluidBuckets3D(
        x0=b.x0 + dt * vpic[0] * b.mask,
        x1=b.x1 + dt * vpic[1] * b.mask,
        x2=b.x2 + dt * vpic[2] * b.mask,
        v0=nv[0] * b.mask,
        v1=nv[1] * b.mask,
        v2=nv[2] * b.mask,
        C00=c_new[0], C01=c_new[1], C02=c_new[2],
        C10=c_new[3], C11=c_new[4], C12=c_new[5],
        C20=c_new[6], C21=c_new[7], C22=c_new[8],
        F00=f_new[0], F01=f_new[1], F02=f_new[2],
        F10=f_new[3], F11=f_new[4], F12=f_new[5],
        F20=f_new[6], F21=f_new[7], F22=f_new[8],
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


def _needs_rebucket(
    b: FluidBuckets3D, cfg: MPMConfig, spec: FastSpec3D, row0=0, row1=0
) -> jax.Array:
    s, k = b.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (s, k), 0)
    r0 = (row0 + rows // spec.rows1).astype(jnp.float32)
    r1 = (row1 + rows % spec.rows1).astype(jnp.float32)
    gx0 = b.x0 * jnp.float32(cfg.inv_dx) + jnp.float32(PAD)
    gx1 = b.x1 * jnp.float32(cfg.inv_dx) + jnp.float32(PAD)
    d0 = jnp.where(b.mask > 0, gx0 - 0.5 - r0, 0.5)
    d1 = jnp.where(b.mask > 0, gx1 - 0.5 - r1, 0.5)
    bad = (d0 <= -0.8) | (d0 >= 1.8) | (d1 <= -0.8) | (d1 >= 1.8)
    return jnp.any(bad)


@partial(jax.jit, static_argnames=("scene", "spec", "n_substeps"))
def run(
    b: FluidBuckets3D, scene: Scene, spec: FastSpec3D, n_substeps: int, t0=None
) -> FluidBuckets3D:
    from mpm_flip98a_tpu.models import colliders as _col

    moving = (
        t0 is not None
        and scene.colliders
        and _col.any_moving(scene.colliders)
    )

    if _os.environ.get("MPM_RUN_WHILE", "1") == "1":
        # Same structure as fast2d.run: margin check as the inner while
        # predicate, rebucket cond hoisted out of the hot body; identical
        # substep/rebucket sequence (bit-exact — tests/test_fast3d.py
        # pins it).  MPM_RUN_WHILE=0 re-selects fori+cond.
        # Carry-flag structure (see fast2d.run): the margin check fuses
        # into the body's particle update; the predicate reads a scalar.
        def inner_cond(c):
            j, s, flag = c
            return jnp.logical_and(j < n_substeps, ~flag)

        def inner_body(c):
            j, s, _ = c
            t = jnp.asarray(t0) + j * scene.cfg.dt if moving else None
            s = substep(s, scene, spec, t=t)
            return j + 1, s, _needs_rebucket(s, scene.cfg, spec)

        def outer_cond(c):
            j, _, _ = c
            return j < n_substeps

        def outer_body(c):
            j, s, flag = c
            j, s, flag = jax.lax.while_loop(
                inner_cond, inner_body, (j, s, flag)
            )

            def fix(q):
                q = rebucket(q, scene.cfg, spec)
                t = jnp.asarray(t0) + j * scene.cfg.dt if moving else None
                q = substep(q, scene, spec, t=t)
                return q, _needs_rebucket(q, scene.cfg, spec)

            s, flag = jax.lax.cond(
                j < n_substeps, fix, lambda q: (q, flag), s
            )
            j = jnp.minimum(j + 1, n_substeps)
            return j, s, flag

        return jax.lax.while_loop(
            outer_cond, outer_body,
            (0, b, _needs_rebucket(b, scene.cfg, spec)),
        )[1]

    def body(i, st):
        st = jax.lax.cond(
            _needs_rebucket(st, scene.cfg, spec),
            lambda s: rebucket(s, scene.cfg, spec),
            lambda s: s,
            st,
        )
        t = jnp.asarray(t0) + i * scene.cfg.dt if moving else None
        return substep(st, scene, spec, t=t)

    return jax.lax.fori_loop(0, n_substeps, body, b)
