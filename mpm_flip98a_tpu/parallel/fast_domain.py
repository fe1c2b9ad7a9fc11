"""Slab-sharded execution of the bucketed fast path (2D).

The scalable multi-chip production path: the grid's row axis is sliced
into slabs, one per chip on a 1D mesh, and — because the fast path's
bucket axis IS the grid row axis — each chip simply owns the bucket rows
of its slab.  The transfers run unchanged on the local (L, K) bucket
window; only two things cross chips, both O(halo), not O(grid):

  1. Grid halo exchange, once per substep: the P2G scatter keeps its edge
     target rows (an (L + 4)-row buffer: 1 row below the slab, 3 above,
     from the +-1-bucket drift margin x 3-tap stencil) and trades them
     with the neighbors — partial sums reduce in, completed rows gather
     back (ppermute, same pattern as parallel/domain.halo_reduce/
     halo_gather for the general path).  After the sync all L + 4 local
     rows hold global sums, so the grid update and G2P are local.
  2. Particle migration, only on rebucket events (every few hundred
     substeps at CFL-respecting dt): slots whose base row left the slab
     ride fixed-capacity ppermute buffers to the adjacent shard and are
     re-bucketed together with the local slots in one sort.

This replaces the O(grid) per-substep all-reduce of the particle-DP fast
path (parallel/fast_replicated.py) with O(halo) communication — the
decomposition BASELINE.json configs[4] ("pod-scale, halo exchange +
particle all-to-all") requires.  SURVEY.md section 2.7.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mpm_flip98a_tpu.config import MPMConfig
from mpm_flip98a_tpu.models import fast2d
from mpm_flip98a_tpu.models.fast2d import FluidBuckets, _field_list, _safe_dead_slots
from mpm_flip98a_tpu.models.stabilized import PAD, Scene
from mpm_flip98a_tpu.ops import binning
from mpm_flip98a_tpu.parallel.domain import _perm_left, _perm_right

# Halo rows of the P2G buffer: bucket row r scatters to target rows
# r - 1 .. r + 3 (rel in {-1, 0, 1} drift x 3-tap stencil), so a slab's
# buffer carries 1 row below and 3 above its L owned rows.
H_LO, H_HI = 1, 3


@dataclasses.dataclass(frozen=True)
class FastDomainSpec:
    """Static decomposition parameters for the sharded fast path."""

    n_shards: int
    rows_per_shard: int   # L: bucket rows per shard (n * L >= num_grids)
    capacity: int         # K slots per bucket row
    mig_cap: int          # migration slots per direction per rebucket

    @staticmethod
    def for_particles(
        cfg: MPMConfig, n_shards: int, p, headroom: float = 2.0
    ) -> "FastDomainSpec":
        rows = -(-cfg.num_grids // n_shards)
        assert rows >= 4, "slabs must be at least 4 rows for the halo window"
        x0 = np.asarray(p.x)[:, 0]
        row = np.floor(x0 * cfg.inv_dx + PAD - 0.5).astype(np.int64)
        occ = int(
            np.bincount(np.clip(row, 0, cfg.num_grids - 1), minlength=cfg.num_grids).max()
        )
        cap = fast2d.capacity_for(occ, headroom)
        return FastDomainSpec(
            n_shards=n_shards,
            rows_per_shard=rows,
            capacity=cap,
            mig_cap=max(128, cap),
        )


@dataclasses.dataclass(frozen=True)
class FastDomainCtx:
    """Runtime context handed to fast2d.substep(domain=...)."""

    axis: str
    n: int

    def halo_sync(self, buf: jax.Array) -> jax.Array:
        """(L + 4, G, nch) row-leading P2G sums -> globally complete rows.

        Reduce: edge partial sums into the owning neighbor's interior;
        gather: completed interior edge rows back into the halos.  Edge
        shards receive ppermute's zero fill — correct on both legs (no
        neighbor => no partial sums, and the out-of-domain halo rows are
        never read with nonzero weight thanks to the 4-cell padding)."""
        n = self.n
        l = buf.shape[0] - (H_LO + H_HI)
        # reduce: my bottom row belongs to the left neighbor's interior,
        # my top 3 rows to the right neighbor's.
        recv = jax.lax.ppermute(buf[0:H_LO], self.axis, _perm_left(n))
        buf = buf.at[l : l + H_LO].add(recv)
        recv = jax.lax.ppermute(buf[l + H_LO :], self.axis, _perm_right(n))
        buf = buf.at[H_LO : H_LO + H_HI].add(recv)
        # gather: completed rows back out to the neighbors' halos.
        recv = jax.lax.ppermute(buf[l : l + H_LO], self.axis, _perm_right(n))
        buf = buf.at[0:H_LO].set(recv)
        recv = jax.lax.ppermute(buf[H_LO : H_LO + H_HI], self.axis, _perm_left(n))
        buf = buf.at[l + H_LO :].set(recv)
        return buf

    def halo_gather_only(self, buf: jax.Array) -> jax.Array:
        """Refresh halo rows from the neighbors' completed interiors
        WITHOUT the reduce leg — for grid-side derivative chains / solves
        (CSF, incompressible projection) whose inputs are already global
        sums.  Works on any (L + 4, ...) row-leading buffer."""
        n = self.n
        l = buf.shape[0] - (H_LO + H_HI)
        recv = jax.lax.ppermute(buf[l : l + H_LO], self.axis, _perm_right(n))
        buf = buf.at[0:H_LO].set(recv)
        recv = jax.lax.ppermute(buf[H_LO : H_LO + H_HI], self.axis, _perm_left(n))
        buf = buf.at[l + H_LO :].set(recv)
        return buf


def distribute(
    p, cfg: MPMConfig, spec: FastDomainSpec, mesh: Mesh, axis: str = "x"
) -> FluidBuckets:
    """Bucket particles by GLOBAL row into the (n * L, K) layout — shard s
    owns rows [s L, (s+1) L) — and place it sharded over the mesh."""
    n, l, k = spec.n_shards, spec.rows_per_shard, spec.capacity
    gspec = fast2d.FastSpec(rows=n * l, capacity=k)
    b = fast2d.from_particles(p, cfg, gspec)
    if int(b.overflow) != 0:
        raise ValueError(f"initial bucketing overflowed capacity {k}")
    b = dataclasses.replace(b, overflow=jnp.zeros((n,), jnp.int32))
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), b)


def rebucket_migrate(
    b: FluidBuckets, scene: Scene, spec: FastDomainSpec, axis: str
) -> FluidBuckets:
    """Per-shard: exchange slots whose base row left the slab with the
    adjacent shards (fixed-capacity ppermute buffers), then re-sort the
    survivors + arrivals into local row buckets in one pass.

    CFL << 1 and the +-1-row rebucket margin mean a particle can only ever
    need the adjacent shard.  Buffer overflow is counted into `overflow`
    (it must stay 0 in a correctly-provisioned run), never silent."""
    cfg = scene.cfg
    n, l, k, m = spec.n_shards, spec.rows_per_shard, spec.capacity, spec.mig_cap
    s = jax.lax.axis_index(axis)
    lo = s * l

    flat = tuple(f.reshape(-1) for f in _field_list(b))
    active = b.mask.reshape(-1) > 0
    inv_dx = jnp.float32(cfg.inv_dx)
    rg = jnp.floor(flat[0] * inv_dx + jnp.float32(PAD) - 0.5).astype(jnp.int32)
    go_l = active & (rg < lo)
    go_r = active & (rg >= lo + l)

    def pack(mask):
        order = jnp.argsort(jnp.logical_not(mask))  # movers first, stable
        idx = order[:m]
        return tuple(f[idx] for f in flat), mask[idx]

    send_l, val_l = pack(go_l)
    send_r, val_r = pack(go_r)
    mig_drop = (
        jnp.maximum(jnp.sum(go_l) - m, 0) + jnp.maximum(jnp.sum(go_r) - m, 0)
    ).astype(jnp.int32)

    pp = lambda tree, perm: jax.tree.map(
        lambda a: jax.lax.ppermute(a, axis, perm), tree
    )
    in_from_right = pp((send_l, val_l), _perm_left(n))
    in_from_left = pp((send_r, val_r), _perm_right(n))

    stay = active & jnp.logical_not(go_l | go_r)
    cat = tuple(
        jnp.concatenate([flat[i], in_from_left[0][i], in_from_right[0][i]])
        for i in range(len(flat))
    )
    act = jnp.concatenate([stay, in_from_left[1], in_from_right[1]])
    row_local = (
        jnp.floor(cat[0] * inv_dx + jnp.float32(PAD) - 0.5).astype(jnp.int32) - lo
    )
    # Guard the one-shard-hop assumption: an arrival still outside [0, l)
    # would be silently clipped into the edge bucket (outside the halo
    # window's +-1-row margin) — count it as overflow instead.
    hop_drop = jnp.sum(
        jnp.where(act & ((row_local < 0) | (row_local >= l)), 1, 0)
    ).astype(jnp.int32)
    fields, mask, ovf = binning.bucket_by_row(row_local, act, cat, l, k)
    return _safe_dead_slots(
        FluidBuckets(
            *fields,
            mask=mask.astype(jnp.float32),
            overflow=b.overflow + ovf + mig_drop + hop_drop,
        )
    )


def make_run(scene: Scene, spec: FastDomainSpec, mesh: Mesh, axis: str = "x"):
    """Build `run(buckets, n_substeps)`: the sharded fast-path stepper with
    adaptive (collective) rebucket + migration."""
    cfg = scene.cfg
    ctx = FastDomainCtx(axis=axis, n=spec.n_shards)
    l = spec.rows_per_shard

    in_spec = FluidBuckets(
        **{f: P(axis) for f in FluidBuckets.__dataclass_fields__}
    )

    def local(bl: FluidBuckets, t) -> FluidBuckets:
        s = jax.lax.axis_index(axis)
        # The rebucket decision must be uniform across shards (migration is
        # a collective): any shard near the margin triggers everyone.
        need = jax.lax.psum(
            fast2d._needs_rebucket(bl, cfg, row0=s * l).astype(jnp.int32), axis
        )
        bl = jax.lax.cond(
            need > 0,
            lambda st: rebucket_migrate(st, scene, spec, axis),
            lambda st: st,
            bl,
        )
        return fast2d.substep(bl, scene, domain=ctx, t=t)

    # Kinematic colliders: t rides in replicated (P()) — the collider BC
    # is pointwise, every shard sees the same scalar.
    from mpm_flip98a_tpu.models import colliders as _col

    moving = bool(scene.colliders) and _col.any_moving(scene.colliders)
    sharded = jax.shard_map(
        local, mesh=mesh, in_specs=(in_spec, P()), out_specs=in_spec,
        check_vma=False,
    )

    @partial(jax.jit, static_argnames=("n_substeps",))
    def run(b: FluidBuckets, n_substeps: int, t0=None) -> FluidBuckets:
        def body(i, st):
            t = (
                jnp.asarray(t0, jnp.float32) + i * cfg.dt
                if (moving and t0 is not None)
                else jnp.float32(0.0)
            )
            return sharded(st, t)

        return jax.lax.fori_loop(0, n_substeps, body, b)

    return run
