"""Slab-sharded fast path on the virtual 8-device CPU mesh.

Contract: same physics as the single-device fast path (models/fast2d.py)
with O(halo) communication — exact agreement while no particle crosses a
slab boundary, ensemble agreement over a long migrating collapse (the
halo changes fp32 summation order on slab-edge rows, which amplifies
chaotically; see CLAUDE.md), zero overflow/migration loss always.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from mpm_flip98a_tpu.config import MPMConfig, TransferKind
from mpm_flip98a_tpu.models import fast2d, scenes
from mpm_flip98a_tpu.parallel import make_mesh
from mpm_flip98a_tpu.parallel.fast_domain import (
    FastDomainSpec,
    distribute,
    make_run,
)

FAST = MPMConfig(
    dtype="float32",
    num_grids=37,
    dt=2e-5,
    num_particles_x=16,
    num_particles_y=32,
    flip_blend=0.98,
    transfer=TransferKind.PIC,
)


def _setup(cfg, n_shards=8):
    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    # Particle ids ride in the material field (a single-fluid scene never
    # reads it) so both runs can be compared particle by particle.
    p = dataclasses.replace(p, material=jnp.arange(p.n, dtype=jnp.int32))
    mesh = make_mesh(n_shards)
    spec = FastDomainSpec.for_particles(cfg, n_shards, p, headroom=2.0)
    b = distribute(p, cfg, spec, mesh)
    return p, scene, mesh, spec, b


def _single_run(p, scene, n):
    spec1 = fast2d.FastSpec.for_particles(scene.cfg, p, headroom=2.0)
    return fast2d.run(fast2d.from_particles(p, scene.cfg, spec1), scene, spec1, n)


def _sorted_xy(host):
    # Ordered by particle id: sorting by position would let fp32
    # summation-order noise reorder lattice particles that share x0.
    x = np.stack([host["x0"], host["x1"]], axis=-1)
    return x[np.argsort(host["mat"])]


def test_short_run_matches_single_fast_path():
    # 100 substeps: interior summation order is identical to the
    # single-device fold, and slab-edge rows differ only by fp32
    # reassociation of the halo adds.
    p, scene, mesh, spec, b = _setup(FAST)
    out = make_run(scene, spec, mesh)(b, 100)
    ref = _single_run(p, scene, 100)
    h, hr = fast2d.to_host(out), fast2d.to_host(ref)
    assert h["x0"].shape == hr["x0"].shape == (p.n,)
    np.testing.assert_allclose(_sorted_xy(h), _sorted_xy(hr), atol=1e-5)
    assert int(np.asarray(out.overflow).sum()) == 0


def test_long_migrating_collapse_tracks_single_fast_path():
    # 3000 substeps at dt = 4e-5 (0.12 s): the fluid front crosses several
    # slab boundaries, so rebucket + ppermute migration must fire.  Judge
    # by ensemble statistics (chaotic fp32 divergence, CLAUDE.md).
    cfg = dataclasses.replace(FAST, dt=4e-5)
    p, scene, mesh, spec, b = _setup(cfg)
    out = make_run(scene, spec, mesh)(b, 3000)
    ref = _single_run(p, scene, 3000)
    assert int(np.asarray(out.overflow).sum()) == 0
    h, hr = fast2d.to_host(out), fast2d.to_host(ref)
    assert h["x0"].shape[0] == p.n  # every particle accounted for
    np.testing.assert_allclose(h["mass"].sum(), hr["mass"].sum(), rtol=1e-6)
    x, xr = _sorted_xy(h), _sorted_xy(hr)
    np.testing.assert_allclose(x.mean(axis=0), xr.mean(axis=0), atol=5e-4)
    np.testing.assert_allclose(x.std(axis=0), xr.std(axis=0), atol=5e-4)

    # Migration actually happened: shards that started empty gained slots.
    mask = np.asarray(out.mask).reshape(spec.n_shards, -1)
    mask0 = np.asarray(b.mask).reshape(spec.n_shards, -1)
    assert ((mask > 0).sum(1) != (mask0 > 0).sum(1)).any()


def test_switch_matrix_matches_single_fast_path():
    # Penalty EBC + fused F-bar + pressure mixing through the sharded path.
    cfg = dataclasses.replace(
        FAST, use_fbar=True, pressure_mixing_ratio=0.5, use_penalty_ebc=True
    )
    p, scene, mesh, spec, b = _setup(cfg)
    out = make_run(scene, spec, mesh)(b, 50)
    ref = _single_run(p, scene, 50)
    np.testing.assert_allclose(
        _sorted_xy(fast2d.to_host(out)), _sorted_xy(fast2d.to_host(ref)), atol=1e-5
    )
    assert int(np.asarray(out.overflow).sum()) == 0
