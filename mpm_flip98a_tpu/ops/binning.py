"""Row-bucketed particle layout of the fast paths.

Particles are bucketed by their stencil base row (grid axis 0; in 3D by
their (axis 0, axis 1) pencil), one fixed-capacity bucket of K slots per
row.  A slab-sharded run owns whole bucket rows, so the layout is what
lets each device hold exactly its slab's particles.

The bucketed layout is the persistent state of the fast path.  Because a
substep moves particles by << 1 cell (CFL), and the slab halo window
tolerates a +-1-row drift margin, `bucket_by_row` only needs to run when
some particle approaches the margin — the fast path triggers it
adaptively (hundreds of substeps apart), so its cost amortises.

Implementation notes:
- ranks within a row come from one `cummax` scan over the sorted keys
  (`searchsorted` lowers to a binary-search loop — never use it in a hot
  path);
- fields move as ONE stacked (S, n_fields) uint32 GATHER through the
  inverse permutation, not per-field scatters: index processing is paid
  once instead of once per field.  All bucket fields are 4-byte, so they
  stack losslessly as uint32 bit patterns (bitcast_convert_type; moves
  copy bits, no arithmetic).

All shapes static: (R, K) slot arrays + validity mask; bucket overflow is
counted, never silently dropped.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def bucket_by_row(
    row: jax.Array,      # (S,) int32 target row per slot (garbage where inactive)
    active: jax.Array,   # (S,) bool
    fields: Tuple[jax.Array, ...],  # each (S,) — slot-major flat views
    num_rows: int,
    capacity: int,
) -> Tuple[Tuple[jax.Array, ...], jax.Array, jax.Array]:
    """Sort slots into (num_rows, capacity) buckets.

    Returns (bucketed fields each (R, K), mask (R, K) bool, overflow count).
    Stable within a row (sort is stable on the flat slot order).  Slots
    beyond a row's capacity are dropped and counted in `overflow` — the
    caller sizes K so this never happens and asserts on the counter.
    """
    s = row.shape[0]
    big = jnp.asarray(num_rows, jnp.int32)
    key = jnp.where(active, jnp.clip(row, 0, num_rows - 1), big)
    order = jnp.argsort(key)  # stable
    key_sorted = key[order]

    # Rank within equal-key runs via one cumulative-max scan.
    i = jnp.arange(s, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), key_sorted[1:] != key_sorted[:-1]]
    )
    seg_start = jax.lax.cummax(jnp.where(is_start, i, 0))
    rank = i - seg_start

    ok = (key_sorted < big) & (rank < capacity)
    overflow = jnp.sum((key_sorted < big) & (rank >= capacity)).astype(jnp.int32)
    nslots = num_rows * capacity
    # Dropped/inactive positions get UNIQUE out-of-bounds indices
    # (nslots + 1 + position): mode="drop" discards them and the
    # unique_indices contract stays honest (a shared sentinel index
    # would be a duplicate-write — UB under unique_indices=True).
    slot = jnp.where(ok, key_sorted * capacity + rank, nslots + 1 + i)

    # Invert the (sorted position -> slot) assignment into slot -> source:
    # one int32 scatter builds the map, then ALL fields + mask move in a
    # single stacked (S, n_fields + 1) uint32 gather (see module notes).
    # Unfilled slots
    # keep index s, gathering the zero sentinel row: identical zero-fill
    # (and mask=False) to the old per-field scatter.
    src_of_slot = (
        jnp.full((nslots,), s, jnp.int32)
        .at[slot]
        .set(order, mode="drop", unique_indices=True)
    )

    stk = jnp.stack(
        [jax.lax.bitcast_convert_type(f, jnp.uint32) for f in fields]
        + [active.astype(jnp.uint32)],
        axis=-1,
    )
    stk = jnp.concatenate([stk, jnp.zeros((1, stk.shape[1]), jnp.uint32)])
    moved = jnp.take(stk, src_of_slot, axis=0)  # (nslots, n_fields + 1)

    bucketed = tuple(
        jax.lax.bitcast_convert_type(moved[:, k], f.dtype).reshape(
            num_rows, capacity
        )
        for k, f in enumerate(fields)
    )
    mask = (moved[:, -1] > 0).reshape(num_rows, capacity)
    return bucketed, mask, overflow
