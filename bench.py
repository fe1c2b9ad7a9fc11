"""Benchmark: fast-path throughput on the 2D and 3D dam-break workloads.

Metric: particle-grid transfer operations per second, where one transfer
op = one particle-node interaction (stencil size 3^dim) in either
direction, i.e. per substep N * 3^dim * 2 (P2G + G2P) — the counting of
the reference workload estimate (BASELINE.md, derived row).

Legs, run in one process on one device:
  2D: 1M particles, 513^2 grid (BASELINE.json 1M-particle dam break);
  3D: 8M particles, 256^3 grid (BASELINE.json configs[3]).
Each leg compiles and warms up, then times one window of substeps ending
in block_until_ready.  A failing leg raises, and the script exits nonzero.

Prints ONE JSON line:
  {"metric": ..., "value": <2D ops/s>, "unit": "ops/s", "detail": {...}}
with the 3D leg under detail.d3 and the device (platform, kind, count)
under detail.device.

Env:
  BENCH_SMALL=1     tiny shapes, for a rehearsal on the CPU
  BENCH_SUBSTEPS=n  timed substeps (default 200 in 2D, 50 in 3D)
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def build_workload(small: bool):
    from mpm_flip98a_tpu.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu.models import scenes

    if small:
        cfg = MPMConfig(
            dtype="float32",
            num_grids=65,
            dt=1e-5,
            num_particles_x=64,
            num_particles_y=128,
            fluid_width=0.105,
            fluid_height=0.21,
            flip_blend=0.98,
            transfer=TransferKind.PIC,
        )
    else:
        # 1M particles, 512^2-cell grid, 8 particles/cell in the column
        # (the BASELINE.json 1M-particle dam-break).  Wide column: spreads
        # slot occupancy evenly across row buckets.
        cfg = MPMConfig(
            dtype="float32",
            num_grids=513,
            dt=2e-6,
            num_particles_x=2000,
            num_particles_y=500,
            fluid_width=0.430,
            fluid_height=0.215,
            flip_blend=0.98,
            transfer=TransferKind.PIC,
        )
    return scenes.dam_break_2d(cfg, dtype=np.float32)


def build_workload3d(small: bool):
    from mpm_flip98a_tpu.models import scenes

    if small:
        return scenes.slab_3d(num_grids=16, particles_per_axis=(16, 16, 4))
    # Full BASELINE.json configs[3] scale: 8M particles, 256^3 grid.
    return scenes.slab_3d(num_grids=256, particles_per_axis=(512, 512, 32))


def _timed(fast, p, scene, n_sub: int) -> dict:
    """Compile + warm up, then time one n_sub window of fast.run."""
    import jax

    spec = fast.FastSpec3D.for_particles(scene.cfg, p) if scene.cfg.dim == 3 \
        else fast.FastSpec.for_particles(scene.cfg, p)
    b = jax.jit(lambda q: fast.from_particles(q, scene.cfg, spec))(p)
    t0 = time.perf_counter()
    b = jax.block_until_ready(fast.run(b, scene, spec, n_sub))
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = jax.block_until_ready(fast.run(b, scene, spec, n_sub))
    elapsed = time.perf_counter() - t0
    if not bool(np.isfinite(np.asarray(b.x0)).all()):
        raise RuntimeError("non-finite state")
    if int(np.asarray(b.overflow)) != 0:
        raise RuntimeError("bucket overflow")
    stencil = 3 ** scene.cfg.dim
    return {
        "value": p.n * stencil * 2 * n_sub / elapsed,
        "detail": {
            "particles": p.n,
            "grid": scene.cfg.num_grids,
            "capacity": spec.capacity,
            "substeps": n_sub,
            "elapsed_s": elapsed,
            "substeps_per_s": n_sub / elapsed,
            "compile_and_first_window_s": warm_s,
        },
    }


def main():
    import jax

    from mpm_flip98a_tpu.models import fast2d, fast3d
    from mpm_flip98a_tpu.utils import compile_cache

    compile_cache.enable()
    small = os.environ.get("BENCH_SMALL") == "1"
    n2 = int(os.environ.get("BENCH_SUBSTEPS", "16" if small else "200"))
    dev = jax.devices()[0]
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    d2 = _timed(fast2d, *build_workload(small), n2)
    d3 = _timed(fast3d, *build_workload3d(small), min(n2, 50))
    d3["metric"] = "particle_grid_transfer_ops_per_sec_3d"
    d3["unit"] = "ops/s"
    print(json.dumps({
        "metric": "particle_grid_transfer_ops_per_sec",
        "value": d2["value"],
        "unit": "ops/s",
        "detail": {**d2["detail"], "d3": d3, "device": device},
    }))


if __name__ == "__main__":
    main()
