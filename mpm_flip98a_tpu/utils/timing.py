"""Wall-clock timing and throughput instrumentation.

Replaces the reference's `Time::Timer` / `TickTimer` / `FPSCounter`
(taichi.h:6098-6160) and the driver's end-of-run `Run Time` print
(exec.py:10,31-32).  Additions the reference lacks: a hard device sync
(materialising one scalar on the host), per-name
accumulated statistics, and a `jax.profiler` trace context for Xprof.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import jax
import jax.numpy as jnp


def device_sync(tree) -> None:
    """Hard sync: force one scalar of the pytree onto the host."""
    leaves = jax.tree.leaves(tree)
    if leaves:
        float(jnp.ravel(leaves[0])[0])


class Timers:
    """Named scoped timers with accumulated totals (taichi.h Timer analogue)."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            device_sync(sync)
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1

    def summary(self) -> str:
        rows = []
        for name in sorted(self.total):
            t, c = self.total[name], self.count[name]
            rows.append(f"{name:24s} {t:8.3f} s  x{c:<6d} {t / c * 1e3:8.2f} ms/call")
        return "\n".join(rows)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Capture an Xprof trace of the enclosed block (jax.profiler)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class ThroughputMeter:
    """Substeps/sec + particle-transfer-ops/sec tracking (FPSCounter analogue)."""

    def __init__(self, particles: int, stencil: int):
        self.particles = particles
        self.stencil = stencil
        self.substeps = 0
        self.elapsed = 0.0

    def update(self, substeps: int, seconds: float) -> None:
        self.substeps += substeps
        self.elapsed += seconds

    @property
    def substeps_per_sec(self) -> float:
        return self.substeps / self.elapsed if self.elapsed else 0.0

    @property
    def transfer_ops_per_sec(self) -> float:
        return self.substeps_per_sec * self.particles * self.stencil * 2
