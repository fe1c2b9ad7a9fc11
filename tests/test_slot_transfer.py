"""Bucket-slot transfers (ops/transfer.p2g_slots / g2p_slots) against the
dense general-path primitives (p2g_scatter / g2p_gather).

The fast paths keep particles in (rows, K) bucket slots, many of them
dead.  These cases pin that the slot transfers equal the dense scatter
and gather over the live particles alone — in 2D and 3D, for the base and
extended channel sets, APIC and PIC, the B-spline and the tent kernel —
that dead slots (filled with NaN here) contribute nothing, and that the
halo layout of a sharded run holds the cropped grid plus the spill rows.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from mpm_flip98a_tpu.config import KernelKind
from mpm_flip98a_tpu.ops import mathx, transfer
from mpm_flip98a_tpu.ops import weights as W

G = 12      # grid nodes per axis
DX = 0.05


def _slots(rng, d, shape, nch, naff):
    """Random live/dead bucket slots: grid coordinates inside the grid's
    stencil-safe interior, channel values and affine coefficients; dead
    slots hold NaN values."""
    gx = [rng.uniform(1.6, G - 2.6, shape).astype(np.float32) for _ in range(d)]
    live = rng.uniform(size=shape) < 0.6
    ch = [rng.normal(size=shape).astype(np.float32) for _ in range(nch)]
    aff = [[rng.normal(size=shape).astype(np.float32) for _ in range(d)] for _ in range(naff)]
    dead = lambda a: np.where(live, a, np.nan).astype(np.float32)
    return (
        [jnp.asarray(a) for a in gx], jnp.asarray(live),
        [jnp.asarray(dead(a)) for a in ch],
        [tuple(jnp.asarray(dead(a)) for a in row) for row in aff],
    )


def _dense_reference(gx, live, ch, aff, kind, grid):
    """General-path formulation on the live slots only."""
    sel = np.asarray(live).reshape(-1)
    x = np.stack([np.asarray(a).reshape(-1)[sel] for a in gx], -1)
    d = x.shape[1]
    offsets = W.stencil_offsets(d)
    base = jnp.floor(jnp.asarray(x) - 0.5).astype(jnp.int32)
    fx = jnp.asarray(x) - base.astype(jnp.float32)
    wst = W.stencil_weights(W.kernel_weights(fx, kind), offsets)
    dpos = W.stencil_dpos(fx, offsets) * DX
    cols = []
    for j, c in enumerate(ch):
        v = jnp.broadcast_to(jnp.asarray(np.asarray(c).reshape(-1)[sel])[:, None], wst.shape)
        if j < len(aff):
            coef = jnp.stack([jnp.asarray(np.asarray(a).reshape(-1)[sel]) for a in aff[j]], -1)
            v = v + jnp.einsum("nb,nsb->ns", coef, dpos, precision="highest")
        cols.append(v)
    values = wst[..., None] * jnp.stack(cols, -1)
    p2g = transfer.p2g_scatter(values, base, offsets, (G,) * d)
    wg = wst[..., None] * transfer.g2p_gather(grid, base, offsets)
    bmat = jnp.einsum("nsa,nsb->nab", wg[..., :d], dpos, precision="highest")
    if kind == KernelKind.BSPLINE:
        c_new = 4.0 / (DX * DX) * bmat
    else:
        dmat = jnp.einsum("ns,nsa,nsb->nab", wst, dpos, dpos, precision="highest")
        c_new = mathx.mm(bmat, mathx.inv(dmat + 1e-12 * jnp.eye(d)))
    return p2g, jnp.sum(wg, axis=1), c_new, sel


@pytest.mark.parametrize("kind", [KernelKind.BSPLINE, KernelKind.TENT], ids=["bspline", "tent"])
@pytest.mark.parametrize("apic", [True, False], ids=["apic", "pic"])
@pytest.mark.parametrize("ext", [False, True], ids=["base", "ext"])
@pytest.mark.parametrize("d", [2, 3])
def test_slots_match_dense_scatter_gather(d, ext, apic, kind):
    # Fast-path channel sets: [m v (d), m v + f (d), m] (+ 4 ext); the
    # pure pair carries the affine term under APIC only, the forced pair
    # always.
    rng = np.random.default_rng(d * 8 + 4 * ext + 2 * apic + (kind == KernelKind.TENT))
    nch = 2 * d + 1 + (4 if ext else 0)
    shape = (G, 3 * G) if d == 2 else (G * G, 8)
    gx, live, ch, aff = _slots(rng, d, shape, nch, 2 * d)
    affine = [aff[j] if (apic or j >= d) else None for j in range(2 * d)]
    affine += [None] * (nch - 2 * d)
    grid = jnp.asarray(rng.normal(size=(G,) * d + (2 * d + (3 if ext else 0),)), jnp.float32)

    st = transfer.slot_stencil(gx, live, kind)
    got = transfer.p2g_slots(st, ch, affine, (G,) * d, DX)
    sums, c_new = transfer.g2p_slots(st, grid, DX, kind)

    ref_aff = [a if a is not None else tuple(jnp.zeros_like(gx[0]) for _ in range(d)) for a in affine[: 2 * d]]
    p2g, ref_sums, ref_c, sel = _dense_reference(gx, live, ch, ref_aff, kind, grid)
    assert got.shape == (G,) * d + (nch,)
    np.testing.assert_allclose(np.asarray(got), np.asarray(p2g), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(sums)[sel], np.asarray(ref_sums), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(c_new)[sel], np.asarray(ref_c), rtol=1e-4, atol=1e-3)
    # Dead slots gather nothing.
    assert np.all(np.asarray(sums)[~sel] == 0.0)
    assert np.all(np.asarray(c_new)[~sel] == 0.0)


@pytest.mark.parametrize("d", [2, 3])
def test_halo_layout_holds_cropped_grid(d):
    # Sharded runs scatter into an (L + 4) halo layout (buffer row j =
    # local target row j - 1); single-device runs into the cropped grid.
    # Slots near the edges spill taps outside [0, L): the halo keeps them,
    # the crop drops them.
    rng = np.random.default_rng(7 + d)
    shape = (G, 3 * G) if d == 2 else (G * G, 8)
    gx = [rng.uniform(0.5, G + 0.4, shape).astype(np.float32) for _ in range(d)]
    gx[-1] = rng.uniform(1.6, G - 2.6, shape).astype(np.float32)  # unsharded axis
    live = jnp.asarray(rng.uniform(size=shape) < 0.6)
    mass = [jnp.asarray(rng.uniform(0.5, 1.5, shape).astype(np.float32))]
    gx = [jnp.asarray(a) for a in gx]
    kind = KernelKind.BSPLINE
    sharded = d - 1  # axes 0 (2D) / 0 and 1 (3D) are shard windows
    shift = [1] * sharded + [0]
    halo_shape = tuple(G + 4 for _ in range(sharded)) + (G,)

    crop = transfer.p2g_slots(transfer.slot_stencil(gx, live, kind), mass, [None], (G,) * d, DX)
    halo = transfer.p2g_slots(
        transfer.slot_stencil(gx, live, kind, shift), mass, [None], halo_shape, DX
    )
    interior = halo[tuple(slice(1, G + 1) for _ in range(sharded))]
    np.testing.assert_allclose(np.asarray(interior), np.asarray(crop), rtol=1e-6, atol=1e-6)
    total = float(np.asarray(mass[0])[np.asarray(live)].sum())
    np.testing.assert_allclose(float(halo.sum()), total, rtol=1e-5)
    assert float(crop.sum()) < total - 1e-3  # the crop dropped the spill taps
