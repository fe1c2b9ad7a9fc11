"""Column crop (fast2d.kernel_cols) correctness.

At num_grids = 128 m + 1 (the headline 513, the sharded-bench 129) the
fast path runs its grid planes at num_grids - 1 columns.  The crop is
exact because the wall band keeps every stencil tap off the last grid
column, with substep clipping the transfer coordinate of any
wall-penetrating outlier — these tests pin that at three levels:
transfer (equal outputs, zero dropped column, penetrator mass
conservation), end-to-end vs the general XLA path, and sharded vs
single-device.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp

from mpm_flip98a_tpu.config import KernelKind, MPMConfig, TransferKind
from mpm_flip98a_tpu.models import fast2d, scenes
from mpm_flip98a_tpu.models.stabilized import PAD, run as run_ref
from mpm_flip98a_tpu.ops import transfer

CROP = MPMConfig(
    dtype="float32",
    num_grids=129,
    dt=2e-5,
    num_particles_x=16,
    num_particles_y=32,
    flip_blend=0.98,
    transfer=TransferKind.PIC,
)


def test_kernel_cols_rule():
    # Crop only at num_grids = 128 m + 1.
    for g, want in ((129, 128), (513, 512), (257, 256), (105, 105), (37, 37)):
        cfg = dataclasses.replace(CROP, num_grids=g)
        assert fast2d.kernel_cols(cfg) == want, (g, want)


def _synthetic_slots(rng, r, k, g, nval):
    """Random bucketed slots whose columns stay inside the wall band
    (gx1 in [PAD, g - 1 - PAD]), rows centered on their bucket; the
    second half of every bucket is dead."""
    gx0 = (
        np.repeat(np.arange(r, dtype=np.float32)[:, None], k, 1)
        + rng.uniform(0.45, 0.55, (r, k)).astype(np.float32)
    )
    gx1 = rng.uniform(float(PAD), float(g - 1 - PAD), (r, k)).astype(np.float32)
    live = np.arange(k)[None, :] < k // 2
    vals = rng.normal(size=(nval, r, k)).astype(np.float32)
    st = transfer.slot_stencil(
        (jnp.asarray(gx0), jnp.asarray(gx1)),
        jnp.asarray(np.broadcast_to(live, (r, k))),
        KernelKind.BSPLINE,
    )
    return st, [jnp.asarray(v) for v in vals]


def test_p2g_cropped_width_exact():
    # Every tap lies inside the wall band, so the cropped grid holds
    # exactly the same sums and the dropped column is exactly zero.
    rng = np.random.default_rng(0)
    r, k, g = 12, 128, 129
    st, vals = _synthetic_slots(rng, r, k, g, 6)
    aff = [tuple(vals[4:6])] + [None] * 5
    full = np.asarray(transfer.p2g_slots(st, vals, aff, (r, g), 1.0))
    crop = np.asarray(transfer.p2g_slots(st, vals, aff, (r, g - 1), 1.0))
    np.testing.assert_array_equal(crop, full[:, : g - 1])
    assert np.all(full[:, g - 1] == 0.0)


def test_g2p_cropped_width_exact():
    rng = np.random.default_rng(1)
    r, k, g = 12, 128, 129
    st, _ = _synthetic_slots(rng, r, k, g, 1)
    grid = rng.normal(size=(r, g, 4)).astype(np.float32)
    grid[:, g - 1] = 0.0  # the massless last column
    kind = KernelKind.BSPLINE
    full = transfer.g2p_slots(st, jnp.asarray(grid), 1.0, kind)
    crop = transfer.g2p_slots(st, jnp.asarray(grid[:, : g - 1]), 1.0, kind)
    for a, b in zip(crop, full):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_transfer_clip_preserves_mass_for_penetrators():
    # A particle transiently past hi + 0.5 would put a stencil tap on the
    # dropped column; substep clips its TRANSFER coordinate to hi + 0.49,
    # which keeps the full scatter inside the cropped width (mass and
    # partition-of-unity preserved), while the raw coordinate at cropped
    # width loses the spill tap's mass.
    g = 129
    hi = g - 1 - int(PAD)
    r = 4

    def mass(gx1):
        st = transfer.slot_stencil(
            (jnp.asarray([1.0], jnp.float32), jnp.asarray([gx1], jnp.float32)),
            jnp.asarray([True]),
            KernelKind.BSPLINE,
        )
        grid = transfer.p2g_slots(
            st, [jnp.ones((1,), jnp.float32)], [None], (r, g - 1), 1.0
        )
        return float(np.asarray(grid).sum())

    assert mass(hi + 0.8) < 1.0 - 1e-3  # spill tap dropped
    np.testing.assert_allclose(mass(hi + 0.49), 1.0, rtol=1e-6)


def _setup(cfg):
    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    spec = fast2d.FastSpec.for_particles(cfg, p, headroom=2.0)
    return p, scene, spec, fast2d.from_particles(p, cfg, spec)


def _sorted_xy(host):
    x = np.stack([host["x0"], host["x1"]], axis=-1)
    order = np.lexsort((x[:, 1], x[:, 0]))
    return x[order]


def test_fast_cropped_matches_general_129():
    # End-to-end at a cropped width vs the independent general path.
    p, scene, spec, b = _setup(CROP)
    assert fast2d.kernel_cols(scene.cfg) == 128
    b5 = fast2d.run(b, scene, spec, 5)
    p5 = run_ref(p, scene, 5)
    x_r = np.asarray(p5.x)
    order = np.lexsort((x_r[:, 1], x_r[:, 0]))
    np.testing.assert_allclose(
        _sorted_xy(fast2d.to_host(b5)), x_r[order], atol=1e-5
    )
    assert int(b5.overflow) == 0


def test_sharded_cropped_matches_single_129():
    from mpm_flip98a_tpu.parallel import make_mesh
    from mpm_flip98a_tpu.parallel.fast_domain import (
        FastDomainSpec,
        distribute,
        make_run,
    )

    p, scene = scenes.dam_break_2d(CROP, dtype=np.float32)
    mesh = make_mesh(4)
    spec = FastDomainSpec.for_particles(CROP, 4, p, headroom=2.0)
    b = distribute(p, CROP, spec, mesh)
    out = make_run(scene, spec, mesh)(b, 20)
    spec1 = fast2d.FastSpec.for_particles(CROP, p, headroom=2.0)
    ref = fast2d.run(fast2d.from_particles(p, CROP, spec1), scene, spec1, 20)
    np.testing.assert_allclose(
        _sorted_xy(fast2d.to_host(out)),
        _sorted_xy(fast2d.to_host(ref)),
        atol=1e-5,
    )
    assert int(np.asarray(out.overflow).sum()) == 0
