"""Measure the fp32 accumulation error budget (VERDICT r3 item 10).

The reference's production dtype is f64 (/root/reference/config.py:17);
the fast paths run fp32.  This script measures what fp32 actually
costs: it advances the TRUE reference configuration (105^2, dt = 1e-6 —
the scene of tests/test_golden_reference.py) in fp32 and fp64 through
the PRE-CHAOTIC early-fall window, where trajectory differences ARE the
accumulated rounding error (not Lyapunov amplification), and reports the
position/velocity drift per substep count.

Also prints the analytic random-walk bound extrapolated to the full
3M-substep production run at 513^2, for docs/PERF.md.

Run:  python scripts/fp32_drift.py          (~6 min CPU)
"""

from __future__ import annotations

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from mpm_flip98a_tpu.config import MPMConfig
from mpm_flip98a_tpu.models import scenes
from mpm_flip98a_tpu.models.stabilized import run

CHECKS = (1000, 5000, 10000, 20000, 30000)


def main():
    cfg64 = MPMConfig()
    assert cfg64.dtype == "float64" and cfg64.dt == 1e-6
    import dataclasses

    cfg32 = dataclasses.replace(cfg64, dtype="float32")
    p64, s64 = scenes.dam_break_2d(cfg64)
    p32, s32 = scenes.dam_break_2d(cfg32, dtype=np.float32)

    done = 0
    print("substeps  max|dx| [m]   max|dx|/dx_cell   max|dv| [m/s]", flush=True)
    dx_cell = cfg64.dx
    for n in CHECKS:
        p64 = run(p64, s64, n - done)
        p32 = run(p32, s32, n - done)
        done = n
        ddx = np.abs(np.asarray(p32.x, np.float64) - np.asarray(p64.x)).max()
        ddv = np.abs(np.asarray(p32.v, np.float64) - np.asarray(p64.v)).max()
        print(f"{n:8d}  {ddx:.3e}      {ddx / dx_cell:.3e}        {ddv:.3e}",
              flush=True)

    # Analytic bound at production scale (513^2, 3M substeps): position
    # accumulation x += dt*v rounds each step at ~0.5 ulp(x); a random
    # walk over N steps gives 0.5*ulp(x)*sqrt(N).
    L = cfg64.domain_length
    ulp = np.spacing(np.float32(L))
    n_prod = 3_000_000
    g_prod = 513
    dx_prod = L / (g_prod - 1 - 4)
    bound = 0.5 * float(ulp) * np.sqrt(n_prod)
    print(f"\nanalytic position random-walk bound @513^2/3M substeps: "
          f"{bound:.3e} m = {bound / dx_prod:.4f} dx_cell", flush=True)


if __name__ == "__main__":
    main()
