"""Slab- and block-sharded execution of the 3D bucketed fast path.

3D counterpart of parallel/fast_domain.py, in one or two mesh axes:

- 1-axis (slabs): the grid's axis 0 is sliced into slabs of pencil-bucket
  rows (bucket pair index = r0 * R1 + r1 is r0-major, so a slab of r0
  rows is a contiguous block of buckets).
- 2-axis (slabs x pencil columns, BASELINE configs[4] pod-scale shapes):
  axis 1 is sliced as well — each shard owns an (L0 x L1) window of
  pencil buckets.  The P2G scatter writes an axis-1 halo plane as well,
  so edge writes ride the exchange instead of being dropped, and the
  halo sync runs the same reduce/gather pattern
  over both mesh axes in sequence (axis 0 first; its full-extent slabs
  carry the corner partial sums into the axis-1 legs, which completes
  diagonal-neighbor contributions without explicit corner messages).

Per substep one halo exchange per sharded axis moves the 4 edge planes
(1 below, 3 above); particles migrate between shards only on collective
rebucket events — axis-0 leg then axis-1 leg, so a corner-crossing
particle reaches its diagonal neighbor in the same rebucket.  Every
fast-path configuration (multi-material, ext stabilization, penalty EBC)
runs unchanged on the local window — fast3d.substep(domain=...).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mpm_flip98a_tpu.config import MPMConfig
from mpm_flip98a_tpu.models import fast3d
from mpm_flip98a_tpu.models.fast3d import (
    FastSpec3D,
    FluidBuckets3D,
    _field_list,
    _safe_dead_slots,
)
from mpm_flip98a_tpu.models.stabilized import PAD, Scene
from mpm_flip98a_tpu.ops import binning
from mpm_flip98a_tpu.parallel.domain import _perm_left, _perm_right
from mpm_flip98a_tpu.parallel.fast_domain import H_HI, H_LO


def _as_shards(n_shards: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    if isinstance(n_shards, int):
        return (n_shards, 1)
    n0, n1 = n_shards
    return (int(n0), int(n1))


@dataclasses.dataclass(frozen=True)
class FastDomain3DSpec:
    n_shards0: int
    n_shards1: int
    rows_per_shard0: int  # L0: axis-0 bucket rows per shard (n0 L0 >= G)
    rows_per_shard1: int  # L1: axis-1 bucket rows per shard (n1 L1 >= G)
    local_spec: FastSpec3D  # rows0 = L0, rows1 = L1
    mig_cap: int

    @property
    def n_shards(self) -> int:
        return self.n_shards0 * self.n_shards1

    @property
    def rows_per_shard(self) -> int:  # 1-axis compatibility alias
        return self.rows_per_shard0

    @staticmethod
    def for_particles(
        cfg: MPMConfig,
        n_shards: Union[int, Tuple[int, int]],
        p,
        headroom: float = 2.0,
    ) -> "FastDomain3DSpec":
        n0, n1 = _as_shards(n_shards)
        g = cfg.num_grids
        rows0 = -(-g // n0)
        rows1 = -(-g // n1)
        assert rows0 >= 4 and rows1 >= 4, (
            "shard windows must be at least 4 rows for the halo exchange"
        )
        x = np.asarray(p.x)
        r0 = np.floor(x[:, 0] * cfg.inv_dx + PAD - 0.5).astype(np.int64)
        r1 = np.floor(x[:, 1] * cfg.inv_dx + PAD - 0.5).astype(np.int64)
        pair = np.clip(r0, 0, g - 1) * g + np.clip(r1, 0, g - 1)
        occ = int(np.bincount(pair, minlength=g * g).max())
        cap = max(128, -(-int(headroom * occ) // 128) * 128)
        return FastDomain3DSpec(
            n_shards0=n0,
            n_shards1=n1,
            rows_per_shard0=rows0,
            rows_per_shard1=rows1,
            local_spec=FastSpec3D(rows0=rows0, rows1=rows1, capacity=cap),
            mig_cap=max(128, cap * 2),
        )


def _sync_dim(buf: jax.Array, axis_name: str, n: int, dim: int) -> jax.Array:
    """One-axis halo reduce + gather on `dim` of a (..., L + 4, ...) halo
    buffer (row j on dim = target row j - 1): edge partial sums reduce
    into the owning neighbor's interior, completed rows gather back.
    Same 4-ppermute pattern as parallel/fast_domain.FastDomainCtx."""
    sl = lambda a, b: (slice(None),) * dim + (slice(a, b),)
    l = buf.shape[dim] - (H_LO + H_HI)
    recv = jax.lax.ppermute(buf[sl(0, H_LO)], axis_name, _perm_left(n))
    buf = buf.at[sl(l, l + H_LO)].add(recv)
    recv = jax.lax.ppermute(buf[sl(l + H_LO, None)], axis_name, _perm_right(n))
    buf = buf.at[sl(H_LO, H_LO + H_HI)].add(recv)
    recv = jax.lax.ppermute(buf[sl(l, l + H_LO)], axis_name, _perm_right(n))
    buf = buf.at[sl(0, H_LO)].set(recv)
    recv = jax.lax.ppermute(buf[sl(H_LO, H_LO + H_HI)], axis_name, _perm_left(n))
    buf = buf.at[sl(l + H_LO, None)].set(recv)
    return buf


@dataclasses.dataclass(frozen=True)
class FastDomain3DCtx:
    """Runtime context handed to fast3d.substep(domain=...)."""

    axis0: str
    n0: int
    axis1: Optional[str] = None  # None: 1-axis slab decomposition
    n1: int = 1

    def halo_sync(self, buf: jax.Array) -> jax.Array:
        """Folded halo sums -> globally complete planes.

        1-axis: buf (L0 + 4, G1, G2, nch), axis-0 sync only.  2-axis:
        buf (L0 + 4, L1 + 4, G2, nch); the axis-0 legs move full slabs
        INCLUDING the axis-1 halo columns, so corner contributions reach
        the diagonal owner through the subsequent axis-1 legs."""
        buf = _sync_dim(buf, self.axis0, self.n0, 0)
        if self.axis1 is not None:
            buf = _sync_dim(buf, self.axis1, self.n1, 1)
        return buf

    def halo_gather_only(self, buf: jax.Array) -> jax.Array:
        """Refresh halo rows/columns from neighbor interiors WITHOUT the
        reduce leg — for grid-side derivative chains / solves (CSF,
        incompressible projection) whose inputs are already global sums.
        Sequential axis legs: after the axis-0 gather, every shard's
        axis-0 halo rows are fresh, so the axis-1 gather also delivers
        valid CORNER values.  Works on any (L0 + 4[, L1 + 4], ...)
        row-leading buffer."""

        def gather_dim(b, axis_name, n, dim):
            sl = lambda a, z: (slice(None),) * dim + (slice(a, z),)
            l = b.shape[dim] - (H_LO + H_HI)
            recv = jax.lax.ppermute(b[sl(l, l + H_LO)], axis_name, _perm_right(n))
            b = b.at[sl(0, H_LO)].set(recv)
            recv = jax.lax.ppermute(b[sl(H_LO, H_LO + H_HI)], axis_name, _perm_left(n))
            b = b.at[sl(l + H_LO, None)].set(recv)
            return b

        buf = gather_dim(buf, self.axis0, self.n0, 0)
        if self.axis1 is not None:
            buf = gather_dim(buf, self.axis1, self.n1, 1)
        return buf


def distribute(
    p, cfg: MPMConfig, spec: FastDomain3DSpec, mesh: Mesh,
    axis: str = "x", axis1: str = "y",
) -> FluidBuckets3D:
    """Bucket by GLOBAL (r0, r1) pencil, reorder to shard-major
    (s0, s1, l0, l1) blocks, and place sharded over the mesh."""
    n0, l0 = spec.n_shards0, spec.rows_per_shard0
    n1, l1 = spec.n_shards1, spec.rows_per_shard1
    k = spec.local_spec.capacity
    gspec = FastSpec3D(rows0=n0 * l0, rows1=n1 * l1, capacity=k)
    b = fast3d.from_particles(p, cfg, gspec)
    if int(b.overflow) != 0:
        raise ValueError(f"initial bucketing overflowed capacity {k}")
    b = dataclasses.replace(b, overflow=jnp.zeros((n0 * n1,), jnp.int32))
    if n1 > 1:
        # Global bucket order is (s0, l0, s1, l1)-major; the sharded
        # layout needs contiguous per-shard blocks, i.e. (s0, s1, l0, l1).
        def reorder(a):
            if a.shape[0] == n0 * n1:  # per-shard scalars (overflow)
                return a
            return a.reshape(n0, l0, n1, l1, *a.shape[1:]).transpose(
                0, 2, 1, 3, *range(4, 4 + a.ndim - 1)
            ).reshape(n0 * n1 * l0 * l1, *a.shape[1:])

        b = jax.tree.map(reorder, b)
        pspec = P((axis, axis1))
    else:
        pspec = P(axis)
    sharding = NamedSharding(mesh, pspec)
    return jax.tree.map(lambda a: jax.device_put(a, sharding), b)


def _exchange_axis(
    flat: tuple, act: jax.Array, row: jax.Array, lo, l: int,
    axis: str, n: int, m: int,
):
    """Send active slots whose bucket row left [lo, lo + l) to the
    adjacent shard on `axis` (fixed-capacity buffers), returning the
    concatenated (stay + arrivals) fields/mask and the overflow count."""
    go_l = act & (row < lo)
    go_r = act & (row >= lo + l)

    def pack(mask):
        order = jnp.argsort(jnp.logical_not(mask))
        idx = order[:m]
        return tuple(f[idx] for f in flat), mask[idx]

    send_l, val_l = pack(go_l)
    send_r, val_r = pack(go_r)
    drop = (
        jnp.maximum(jnp.sum(go_l) - m, 0) + jnp.maximum(jnp.sum(go_r) - m, 0)
    ).astype(jnp.int32)

    pp = lambda tree, perm: jax.tree.map(
        lambda a: jax.lax.ppermute(a, axis, perm), tree
    )
    in_from_right = pp((send_l, val_l), _perm_left(n))
    in_from_left = pp((send_r, val_r), _perm_right(n))

    stay = act & jnp.logical_not(go_l | go_r)
    cat = tuple(
        jnp.concatenate([flat[i], in_from_left[0][i], in_from_right[0][i]])
        for i in range(len(flat))
    )
    cat_act = jnp.concatenate([stay, in_from_left[1], in_from_right[1]])
    return cat, cat_act, drop


def rebucket_migrate(
    b: FluidBuckets3D, scene: Scene, spec: FastDomain3DSpec,
    axis: str, axis1: Optional[str] = None,
) -> FluidBuckets3D:
    """Exchange slots that left the shard window with the adjacent shards
    (axis-0 leg, then axis-1 leg — a corner-crossing particle reaches the
    diagonal neighbor through both), then re-sort survivors + arrivals
    into local pencil buckets (one bucket_by_row pass)."""
    cfg = scene.cfg
    l0, l1 = spec.rows_per_shard0, spec.rows_per_shard1
    k, m = spec.local_spec.capacity, spec.mig_cap
    lo0 = jax.lax.axis_index(axis) * l0

    flat = tuple(f.reshape(-1) for f in _field_list(b))
    act = b.mask.reshape(-1) > 0
    inv_dx = jnp.float32(cfg.inv_dx)
    brow = lambda xs: jnp.floor(
        xs * inv_dx + jnp.float32(PAD) - 0.5
    ).astype(jnp.int32)

    flat, act, drop0 = _exchange_axis(
        flat, act, brow(flat[0]), lo0, l0, axis, spec.n_shards0, m
    )
    if axis1 is not None:
        lo1 = jax.lax.axis_index(axis1) * l1
        flat, act, drop1 = _exchange_axis(
            flat, act, brow(flat[1]), lo1, l1, axis1, spec.n_shards1, m
        )
    else:
        lo1 = 0
        drop1 = jnp.int32(0)

    r0a = brow(flat[0]) - lo0
    r1a = brow(flat[1]) - lo1
    # A particle that crossed MORE than one shard window between rebuckets
    # would be silently re-homed into the edge bucket by the clip below
    # and sit outside the halo window's +-1-row margin — count it into
    # the overflow counter so the one-shard-hop provisioning assumption is
    # guarded by the existing overflow == 0 test invariant.
    hop_drop = jnp.sum(
        jnp.where(
            act & ((r0a < 0) | (r0a >= l0) | (r1a < 0) | (r1a >= l1)), 1, 0
        )
    ).astype(jnp.int32)
    pair = jnp.clip(r0a, 0, l0 - 1) * l1 + jnp.clip(r1a, 0, l1 - 1)
    fields, mask, ovf = binning.bucket_by_row(pair, act, flat, l0 * l1, k)
    return _safe_dead_slots(
        FluidBuckets3D(
            *fields,
            mask=mask.astype(jnp.float32),
            overflow=b.overflow + ovf + drop0 + drop1 + hop_drop,
        )
    )


def make_run(
    scene: Scene, spec: FastDomain3DSpec, mesh: Mesh,
    axis: str = "x", axis1: str = "y",
):
    """Build `run(buckets, n_substeps)`: the sharded 3D fast-path stepper
    with adaptive (collective) rebucket + migration."""
    cfg = scene.cfg
    two_axis = spec.n_shards1 > 1
    ax1 = axis1 if two_axis else None
    ctx = FastDomain3DCtx(
        axis0=axis, n0=spec.n_shards0, axis1=ax1, n1=spec.n_shards1
    )
    lspec = spec.local_spec
    l0, l1 = spec.rows_per_shard0, spec.rows_per_shard1

    pspec = P((axis, axis1)) if two_axis else P(axis)
    in_spec = FluidBuckets3D(
        **{f: pspec for f in FluidBuckets3D.__dataclass_fields__}
    )

    def local(bl: FluidBuckets3D, t) -> FluidBuckets3D:
        s0 = jax.lax.axis_index(axis)
        row1 = jax.lax.axis_index(axis1) * l1 if two_axis else 0
        need = fast3d._needs_rebucket(
            bl, cfg, lspec, row0=s0 * l0, row1=row1
        ).astype(jnp.int32)
        need = jax.lax.psum(need, axis)
        if two_axis:
            need = jax.lax.psum(need, axis1)
        bl = jax.lax.cond(
            need > 0,
            lambda st: rebucket_migrate(st, scene, spec, axis, ax1),
            lambda st: st,
            bl,
        )
        return fast3d.substep(bl, scene, lspec, domain=ctx, t=t)

    # Kinematic colliders: t rides in replicated (P()) — pointwise BC,
    # every shard sees the same scalar.
    from mpm_flip98a_tpu.models import colliders as _col

    moving = bool(scene.colliders) and _col.any_moving(scene.colliders)
    sharded = jax.shard_map(
        local, mesh=mesh, in_specs=(in_spec, P()), out_specs=in_spec,
        check_vma=False,
    )

    @partial(jax.jit, static_argnames=("n_substeps",))
    def run(b: FluidBuckets3D, n_substeps: int, t0=None) -> FluidBuckets3D:
        def body(i, st):
            t = (
                jnp.asarray(t0, jnp.float32) + i * cfg.dt
                if (moving and t0 is not None)
                else jnp.float32(0.0)
            )
            return sharded(st, t)

        return jax.lax.fori_loop(0, n_substeps, body, b)

    return run
