"""Produce the sand-column demo GIF (Drucker-Prager SAND material: the
column loses its footing and flows into an angle-of-repose pile).

    python scripts/make_sand_gif.py [--frames 120] [--out docs]

Runs on the default platform (the accelerator when there is one; pass --cpu for a
CPU render).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from mpm_flip98a_tpu.config import MPMConfig
from mpm_flip98a_tpu.driver import Simulation
from mpm_flip98a_tpu.models import scenes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out", default="docs")
    ap.add_argument("--dt", type=float, default=2e-5)
    ap.add_argument("--substeps", type=int, default=500)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    cfg = MPMConfig(dtype="float32", num_grids=65, dt=args.dt)
    p, scene = scenes.sand_column_2d(
        cfg, dtype=np.float32, particles_per_axis=(40, 108)
    )
    sim = Simulation(p, scene, path="fast", out_dir=args.out, tag="sand")
    sim.run(n_frames=args.frames, substeps_per_frame=args.substeps, gif=True)
    src = f"{sim.frame_dir}/output.gif"
    dst = os.path.join(args.out, "sand.gif")
    os.replace(src, dst)
    print("wrote", dst)


if __name__ == "__main__":
    main()
