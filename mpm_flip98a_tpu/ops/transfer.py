"""Particle <-> grid transfer primitives (P2G scatter, G2P gather).

These are the reference's hot loops (cpp_validation/mls-mpm88-explained.cpp:
53-102 P2G, :133-179 G2P; SURVEY.md section 3.1), written for XLA:

- All 3^dim stencil contributions are materialised along a static stencil
  axis and scattered/gathered in ONE XLA scatter-add / gather op.  No
  Python-level per-particle loops, no data-dependent shapes.
- The general path (models/stabilized.py) calls `p2g_scatter` /
  `g2p_gather` on dense particle arrays; the bucketed fast paths
  (models/fast2d.py, fast3d.py) call `slot_stencil` / `p2g_slots` /
  `g2p_slots`, which flatten the bucket slots and reuse the same two ops.

Index convention: grid arrays have shape (G, ..., G, c); flat scatter uses
row-major ravel of the node index.  Out-of-range stencil nodes are
dropped by the scatter and read as zero by the gather (cannot happen
in-domain because the reference pads the grid — 4 cells outside the
physical domain, config.py:39 — but it keeps the ops total functions and
lets local / cropped buffers drop what they do not hold).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from mpm_flip98a_tpu.config import KernelKind
from mpm_flip98a_tpu.ops import mathx
from mpm_flip98a_tpu.ops import weights as W


def _flat_node_index(
    base: jax.Array, offsets: np.ndarray, grid_shape: Tuple[int, ...]
) -> jax.Array:
    """Flattened node indices for every (particle, stencil node) pair.

    base: (N, d) int32; offsets: (S, d) static.
    Returns flat (N, S) int32; out-of-range pairs get the index one past
    the last node.
    """
    idx = base[:, None, :] + jnp.asarray(offsets)[None, :, :]  # (N, S, d)
    in_bounds = jnp.all(
        (idx >= 0) & (idx < jnp.asarray(grid_shape, jnp.int32)[None, None, :]), axis=-1
    )
    strides = np.concatenate(
        [np.cumprod(np.asarray(grid_shape[1:], np.int64)[::-1])[::-1], [1]]
    ).astype(np.int32)
    flat = jnp.sum(idx * jnp.asarray(strides)[None, None, :], axis=-1)
    return jnp.where(in_bounds, flat, int(np.prod(grid_shape)))


def p2g_scatter(
    values: jax.Array,
    base: jax.Array,
    offsets: np.ndarray,
    grid_shape: Tuple[int, ...],
) -> jax.Array:
    """Scatter-add per-(particle, stencil-node) values onto the grid.

    values: (N, S, c) — already weighted contributions for each stencil node
    base:   (N, d) int32 base node per particle
    Returns grid (G..., c).

    One `jnp.ndarray.at[].add` over the flattened grid — XLA lowers this to
    its native scatter-add (atomic adds on a GPU; an order-independent sum
    up to fp32 reassociation).  Out-of-range pairs are dropped, so they
    cost no atomic.
    """
    n, s, c = values.shape
    flat = _flat_node_index(base, offsets, grid_shape)
    num_nodes = int(np.prod(grid_shape))
    out = jnp.zeros((num_nodes, c), values.dtype)
    out = out.at[flat.reshape(-1)].add(values.reshape(-1, c), mode="drop")
    return out.reshape(grid_shape + (c,))


def g2p_gather(
    grid: jax.Array,
    base: jax.Array,
    offsets: np.ndarray,
) -> jax.Array:
    """Gather grid values at every stencil node of every particle.

    grid: (G..., c); base: (N, d) int32.
    Returns (N, S, c); out-of-range nodes read as zero.
    """
    grid_shape = grid.shape[:-1]
    c = grid.shape[-1]
    flat = _flat_node_index(base, offsets, grid_shape)
    flat_grid = grid.reshape(-1, c)
    return flat_grid.at[flat.reshape(-1)].get(mode="fill", fill_value=0).reshape(
        flat.shape + (c,)
    )


# ---------------------------------------------------------------------------
# Bucket-slot transfers (fast paths)
# ---------------------------------------------------------------------------


class SlotStencil(NamedTuple):
    """Stencil of every bucket slot (flattened to N = slots)."""

    offsets: np.ndarray   # (S, d) static
    base: jax.Array       # (N, d) int32 buffer index of the stencil origin
    wst: jax.Array        # (N, S) tensor-product weights
    dpos: jax.Array       # (N, S, d) node - particle, grid units


def slot_stencil(
    gx: Sequence[jax.Array],
    live: jax.Array,
    kind: KernelKind,
    shift: Optional[Sequence] = None,
) -> SlotStencil:
    """Stencil weights of bucket slots.

    gx: d arrays of grid coordinates (any common shape, flattened here);
    live: bool mask of the same shape; `shift` (d ints, static or traced)
    is added to the base node to index a local / halo buffer.  Dead slots
    get a base of -3 on every axis, so every tap is out of range: the
    scatter drops them without an atomic and the gather reads zeros."""
    d = len(gx)
    g = jnp.stack([a.reshape(-1) for a in gx], axis=-1)
    offsets = W.stencil_offsets(d)
    base = jnp.floor(g - jnp.asarray(0.5, g.dtype)).astype(jnp.int32)
    fx = g - base.astype(g.dtype)
    wst = W.stencil_weights(W.kernel_weights(fx, kind), offsets)
    dpos = W.stencil_dpos(fx, offsets)
    if shift is not None:
        base = base + jnp.stack([jnp.asarray(s, jnp.int32) for s in shift])
    base = jnp.where(live.reshape(-1)[:, None], base, -3)
    return SlotStencil(offsets, base, wst, dpos)


def p2g_slots(
    st: SlotStencil,
    channels: Sequence[jax.Array],
    affine: Sequence,
    grid_shape: Tuple[int, ...],
    dx: float,
) -> jax.Array:
    """Scatter bucket slots onto a channel-last grid (grid_shape + (c,)).

    Channel j of slot p deposits w_ps (channels[j]_p + dx * sum_a
    affine[j][a]_p dpos_psa) on stencil node s: the APIC / MLS affine
    momentum (mls-mpm88-explained.cpp:79-99) when affine[j] is a d-tuple
    of coefficient arrays, the plain weighted value when it is None."""
    dpos = st.dpos * jnp.asarray(dx, st.dpos.dtype)
    cols = []
    for j, ch in enumerate(channels):
        v = jnp.broadcast_to(ch.reshape(-1)[:, None], st.wst.shape)
        if affine[j] is not None:
            for a, coef in enumerate(affine[j]):
                v = v + coef.reshape(-1)[:, None] * dpos[..., a]
        cols.append(v)
    values = st.wst[..., None] * jnp.stack(cols, axis=-1)
    return p2g_scatter(values, st.base, st.offsets, grid_shape)


def g2p_slots(
    st: SlotStencil, grid: jax.Array, dx: float, kind: KernelKind
) -> Tuple[jax.Array, jax.Array]:
    """Gather a channel-last grid back to the slots.

    Returns (sums (N, c): weighted channel sums, C (N, d, d): the APIC
    velocity gradient of the first d channels, sum_s w v dpos^T D^-1).
    The quadratic B-spline has the constant D = (dx^2/4) I
    (mls-mpm88-explained.cpp:79); other kernels invert the per-slot
    D = sum w dpos dpos^T like the general path."""
    d = st.dpos.shape[-1]
    wg = st.wst[..., None] * g2p_gather(grid, st.base, st.offsets)
    sums = jnp.sum(wg, axis=1)
    dpos = st.dpos * jnp.asarray(dx, st.dpos.dtype)
    bmat = jnp.sum(wg[..., :d, None] * dpos[..., None, :], axis=1)
    if kind == KernelKind.BSPLINE:
        return sums, (4.0 / (dx * dx)) * bmat
    d_mat = jnp.sum(
        st.wst[..., None, None] * dpos[..., :, None] * dpos[..., None, :], axis=1
    )
    d_mat = d_mat + jnp.asarray(1e-12, d_mat.dtype) * jnp.eye(d, dtype=d_mat.dtype)
    return sums, mathx.mm(bmat, mathx.inv(d_mat))
