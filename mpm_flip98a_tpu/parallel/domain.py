"""Slab domain decomposition: sharded grid + halo exchange + migration.

The scalable multi-chip path (SURVEY.md section 2.7): the background grid is
sliced into slabs along axis 0, one slab per chip on a 1D mesh.  Each chip
keeps a local buffer of its slab plus a 2-node halo on both sides (the
quadratic B-spline stencil reach, config.py:41-43):

    local rows [0, H) | interior [H, L+H) | [L+H, L+2H)
    = global  [sL-H, sL) |  [sL, (s+1)L)  | [(s+1)L, (s+1)L+H)

Per substep, every P2G scatter is followed by one `halo_sync`:
  1. halo-reduce : edge strips (partial sums that belong to a neighbor's
     interior) ride `jax.lax.ppermute` to that neighbor and are added in —
     after this every interior row holds the complete global sum.
  2. halo-gather : completed interior edge strips are copied back out to the
     neighbors' halos — after this all L+2H rows are globally correct, so
     the grid update (pointwise) and G2P (local gather) need no further
     communication.

Both exchanges use non-ring permutations (no wraparound: `ppermute`
zero-fills absent sources), so the domain edges need no masking.

Particles are stored per shard in fixed-capacity SoA buffers with inert
padding (mass = volume0 = 0); after advection, particles whose stencil base
row leaves the owned slab migrate to the adjacent shard through
fixed-capacity send buffers — static shapes everywhere, validity masks
instead of ragged data (SURVEY.md section 7, hard part c).  CFL << 1 means
a particle can only ever move to an adjacent shard per substep.

Overflowed migration buffers or destination shards drop particles and count
them in `DomainState.dropped` (a psum-visible diagnostic; it must stay 0 in
any correctly-provisioned run, and tests assert that).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mpm_flip98a_tpu.config import MPMConfig
from mpm_flip98a_tpu.models.stabilized import (
    PAD,
    GridContext,
    Scene,
    _col_moving,
    substep,
)
from mpm_flip98a_tpu.state import Particles

H = 2  # halo width in grid rows = stencil reach (config.py:41-43)


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_pytree_dataclass
class DomainState:
    particles: Particles   # (n_shards * capacity, ...) sharded on axis 0
    dropped: jax.Array     # (n_shards,) int32 — particles lost to overflow


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """Static decomposition parameters."""

    n_shards: int
    rows_per_shard: int   # L: slab height in grid rows
    capacity: int         # particle slots per shard
    mig_cap: int          # migration slots per direction per substep

    @staticmethod
    def for_scene(cfg: MPMConfig, n_shards: int, n_particles: int, headroom: float = 2.0) -> "DomainSpec":
        rows = -(-cfg.num_grids // n_shards)
        cap = max(64, int(headroom * -(-n_particles // n_shards)))
        # Round capacity up to a multiple of 64.
        cap = -(-cap // 64) * 64
        return DomainSpec(
            n_shards=n_shards,
            rows_per_shard=rows,
            capacity=cap,
            mig_cap=max(16, cap // 4),
        )

    @staticmethod
    def for_particles(
        cfg: MPMConfig, n_shards: int, p: Particles, headroom: float = 2.0
    ) -> "DomainSpec":
        """Size capacity from the ACTUAL initial slab occupancy — free-surface
        scenes are spatially skewed (the dam column fills only the left
        slabs, config.py:33-35), so N/n_shards is the wrong yardstick."""
        rows = -(-cfg.num_grids // n_shards)
        x0 = np.asarray(p.x)[:, 0]
        row = np.floor(x0 * cfg.inv_dx + PAD - 0.5).astype(np.int64)
        shard = np.clip(row // rows, 0, n_shards - 1)
        occupancy = int(np.bincount(shard, minlength=n_shards).max())
        cap = max(64, int(headroom * occupancy))
        cap = -(-cap // 64) * 64
        return DomainSpec(
            n_shards=n_shards,
            rows_per_shard=rows,
            capacity=cap,
            mig_cap=max(16, cap // 4),
        )


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def _perm_left(n):   # shard i sends to i-1
    return [(i, i - 1) for i in range(1, n)]


def _perm_right(n):  # shard i sends to i+1
    return [(i, i + 1) for i in range(n - 1)]


def halo_reduce(buf: jax.Array, axis: str, n: int, L: int) -> jax.Array:
    """Add edge-strip partial sums into the owning neighbor's interior."""
    from_right = jax.lax.ppermute(buf[:H], axis, _perm_left(n))
    from_left = jax.lax.ppermute(buf[L + H : L + 2 * H], axis, _perm_right(n))
    buf = buf.at[L : L + H].add(from_right)
    buf = buf.at[H : 2 * H].add(from_left)
    return buf


def halo_gather(buf: jax.Array, axis: str, n: int, L: int) -> jax.Array:
    """Copy completed neighbor interior strips into the local halos."""
    from_right = jax.lax.ppermute(buf[H : 2 * H], axis, _perm_left(n))
    from_left = jax.lax.ppermute(buf[L : L + H], axis, _perm_right(n))
    buf = buf.at[L + H : L + 2 * H].set(from_right)
    buf = buf.at[:H].set(from_left)
    return buf


def make_halo_sync(axis: str, n: int, L: int):
    def sync(buf: jax.Array) -> jax.Array:
        return halo_gather(halo_reduce(buf, axis, n, L), axis, n, L)

    return sync


# ---------------------------------------------------------------------------
# Particle migration
# ---------------------------------------------------------------------------


def _take_rows(p, idx):
    return jax.tree.map(lambda a: a[idx], p)


def _set_rows(p, idx, rows, ok):
    def setter(a, r):
        mask = ok.reshape((-1,) + (1,) * (a.ndim - 1))
        return a.at[idx].set(jnp.where(mask, r, a[idx]))

    return jax.tree.map(setter, p, rows)


def _base_row(p: Particles, cfg: MPMConfig) -> jax.Array:
    dt = p.x.dtype
    gx0 = p.x[:, 0] * jnp.asarray(cfg.inv_dx, dt) + jnp.asarray(PAD, dt)
    return jnp.floor(gx0 - jnp.asarray(0.5, dt)).astype(jnp.int32)


def _deactivate(p: Particles, mask: jax.Array, slab_center_x: jax.Array) -> Particles:
    """Turn departed rows inert: zero weight, parked at the slab center."""
    d = p.dim
    dt = p.x.dtype
    m = mask
    md = mask[:, None]

    center = jnp.broadcast_to(slab_center_x, p.x.shape)
    eye = jnp.broadcast_to(jnp.eye(d, dtype=dt), p.F.shape)
    return Particles(
        x=jnp.where(md, center, p.x),
        v=jnp.where(md, 0.0, p.v),
        C=jnp.where(md[..., None], 0.0, p.C),
        F=jnp.where(md[..., None], eye, p.F),
        J=jnp.where(m, 1.0, p.J),
        stress=jnp.where(md[..., None], 0.0, p.stress),
        material=jnp.where(m, 0, p.material),
        volume0=jnp.where(m, 0.0, p.volume0),
        mass=jnp.where(m, 0.0, p.mass),
        density=jnp.where(m, 1.0, p.density),
        pressure=jnp.where(m, 0.0, p.pressure),
        div_v=jnp.where(m, 0.0, p.div_v),
        pou=jnp.where(m, 0.0, p.pou),
        consistency=jnp.where(md, 0.0, p.consistency),
        Jp=jnp.where(m, 1.0, p.Jp),
    )


def migrate(
    p: Particles,
    dropped: jax.Array,
    scene: Scene,
    spec: DomainSpec,
    axis: str,
) -> Tuple[Particles, jax.Array]:
    """Move particles whose base row left the owned slab to the neighbor
    shard (fixed-capacity ragged all-to-all; SURVEY.md 2.7)."""
    cfg = scene.cfg
    n, L, M = spec.n_shards, spec.rows_per_shard, spec.mig_cap
    s = jax.lax.axis_index(axis)
    lo = s * L
    hi = lo + L

    active = p.mass > 0
    row = _base_row(p, cfg)
    go_left = active & (row < lo)
    go_right = active & (row >= hi)

    def pack(mask):
        order = jnp.argsort(jnp.logical_not(mask))  # True rows first, stable
        idx = order[:M]
        valid = mask[idx]
        return _take_rows(p, idx), valid, mask

    rows_l, valid_l, _ = pack(go_left)
    rows_r, valid_r, _ = pack(go_right)

    # Anything beyond the migration buffer is dropped (counted).
    overflow = (
        jnp.maximum(jnp.sum(go_left) - M, 0) + jnp.maximum(jnp.sum(go_right) - M, 0)
    )

    # Deactivate every departing row locally.
    dt = p.x.dtype
    center_row = (lo + L // 2 - PAD) * cfg.dx
    slab_center = jnp.full((p.dim,), 0.5 * cfg.domain_length, dt)
    slab_center = slab_center.at[0].set(jnp.asarray(center_row, dt))
    p = _deactivate(p, go_left | go_right, slab_center)
    active = p.mass > 0

    # Exchange: my left-goers -> left neighbor; my right-goers -> right.
    send = lambda tree, perm: jax.tree.map(
        lambda a: jax.lax.ppermute(a, axis, perm), tree
    )
    in_from_right = send((rows_l, valid_l), _perm_left(n))   # their left-goers
    in_from_left = send((rows_r, valid_r), _perm_right(n))   # their right-goers

    # Merge into free slots: inert rows first in a stable argsort of active.
    free = jnp.argsort(active)  # False (free) slots first
    num_free = jnp.sum(jnp.logical_not(active))

    def place(p, incoming, start):
        rows, valid = incoming
        slot_rank = start + jnp.arange(M)
        ok = valid & (slot_rank < num_free)
        idx = free[slot_rank]
        return _set_rows(p, idx, rows, ok), jnp.sum(valid & jnp.logical_not(ok))

    p, lost1 = place(p, in_from_left, 0)
    # Offset the second placement by the ACTUAL number of valid left-side
    # arrivals (not the static buffer size M): otherwise up to M-1 free
    # slots sit unused between the two groups and right-side arrivals get
    # counted dropped even though room exists.
    p, lost2 = place(p, in_from_right, jnp.sum(in_from_left[1]))
    return p, dropped + (overflow + lost1 + lost2).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Distribution and the sharded runner
# ---------------------------------------------------------------------------


def distribute(
    p: Particles, scene: Scene, spec: DomainSpec, mesh: Mesh, axis: str = "x"
) -> Tuple[DomainState, np.ndarray]:
    """Host-side: bucket particles by owning slab, pad each bucket to
    capacity with inert rows, and device_put the result sharded over the
    mesh.  Returns (state, perm) where perm[i] = destination row of input
    particle i (useful for tests while no migration has happened)."""
    cfg = scene.cfg
    n, L, C = spec.n_shards, spec.rows_per_shard, spec.capacity
    x = np.asarray(p.x)
    row = np.floor(x[:, 0] * cfg.inv_dx + PAD - 0.5).astype(np.int64)
    shard = np.clip(row // L, 0, n - 1)

    perm = np.zeros(p.n, np.int64)
    chunks = []
    for s in range(n):
        idx = np.nonzero(shard == s)[0]
        if len(idx) > C:
            raise ValueError(
                f"shard {s} needs {len(idx)} slots but capacity is {C}"
            )
        perm[idx] = s * C + np.arange(len(idx))
        local = jax.tree.map(lambda a: np.asarray(a)[idx], p)
        pad = C - len(idx)
        center_row = (s * L + L // 2 - PAD) * cfg.dx
        center = np.full((pad, p.dim), 0.5 * cfg.domain_length)
        center[:, 0] = center_row

        def padded(a, fill, block=None):
            blk = (
                np.broadcast_to(fill, (pad,) + a.shape[1:]).astype(a.dtype)
                if block is None
                else block.astype(a.dtype)
            )
            return np.concatenate([np.asarray(a), blk], axis=0)

        eye = np.broadcast_to(np.eye(p.dim), (pad, p.dim, p.dim))
        chunks.append(
            Particles(
                x=padded(local.x, 0.0, center),
                v=padded(local.v, 0.0),
                C=padded(local.C, 0.0),
                F=padded(local.F, 0.0, eye),
                J=padded(local.J, 1.0),
                stress=padded(local.stress, 0.0),
                material=padded(local.material, 0),
                volume0=padded(local.volume0, 0.0),
                mass=padded(local.mass, 0.0),
                density=padded(local.density, 1.0),
                pressure=padded(local.pressure, 0.0),
                div_v=padded(local.div_v, 0.0),
                pou=padded(local.pou, 0.0),
                consistency=padded(local.consistency, 0.0),
                Jp=padded(local.Jp, 1.0),
            )
        )

    full = jax.tree.map(lambda *a: np.concatenate(a, axis=0), *chunks)
    sharding = NamedSharding(mesh, P(axis))
    particles = jax.tree.map(
        lambda a: jax.device_put(jnp.asarray(a), sharding), full
    )
    dropped = jax.device_put(
        jnp.zeros((n,), jnp.int32), NamedSharding(mesh, P(axis))
    )
    return DomainState(particles=particles, dropped=dropped), perm


def make_run(scene: Scene, spec: DomainSpec, mesh: Mesh, axis: str = "x"):
    """Build `run(state, n_substeps)` — the fully sharded trainer-equivalent
    step: slab grids, halo exchange, migration, all inside one jit."""
    cfg = scene.cfg
    d = cfg.dim
    n, L = spec.n_shards, spec.rows_per_shard

    node_shape = (L + 2 * H,) + (cfg.num_grids,) * (d - 1)
    cell_shape = (L + 2 * H,) + (cfg.num_cells,) * (d - 1)
    sync = make_halo_sync(axis, n, L)

    def local(state: DomainState, t) -> DomainState:
        s = jax.lax.axis_index(axis)
        shift = jnp.zeros((d,), jnp.int32).at[0].set(s * L - H)
        ctx = GridContext(
            node_shape=node_shape,
            cell_shape=cell_shape,
            base_shift=shift,
            row_index0=s * L - H + jnp.arange(L + 2 * H),
            axis=axis,
            # Halo refresh for grid-side derivative chains (CSF) and the
            # projection's per-iteration q exchange: copy the neighbors'
            # completed interior rows into the local halos.
            halo_exchange=lambda buf: halo_gather(buf, axis, n, L),
            own_rows=(jnp.arange(L + 2 * H) >= H) & (jnp.arange(L + 2 * H) < L + H),
        )

        def body(_, st: DomainState) -> DomainState:
            pnew = substep(st.particles, scene, grid_reduce=sync, ctx=ctx, t=t)
            pnew, dropped = migrate(pnew, st.dropped, scene, spec, axis)
            return DomainState(particles=pnew, dropped=dropped)

        return body(0, state)

    # Kinematic colliders: t rides in replicated (P()); the collider BC is
    # pointwise so every shard sees the same scalar.
    moving = _col_moving(scene)
    sharded = jax.shard_map(
        local, mesh=mesh, in_specs=(P(axis), P()), out_specs=P(axis)
    )

    @partial(jax.jit, static_argnames=("n_substeps",))
    def run(state: DomainState, n_substeps: int, t0=None) -> DomainState:
        def outer(i, st):
            t = (
                jnp.asarray(t0, jnp.float32) + i * cfg.dt
                if (moving and t0 is not None)
                else jnp.float32(0.0)
            )
            return sharded(st, t)

        return jax.lax.fori_loop(0, n_substeps, outer, state)

    return run


def collect(state: DomainState) -> Particles:
    """Host-side: pull the active particles back into a dense array
    (ordering is by shard, then slot)."""
    p = jax.tree.map(np.asarray, state.particles)
    active = p.mass > 0
    return jax.tree.map(lambda a: a[active], p)
