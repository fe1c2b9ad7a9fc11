"""Produce the rigid-collider demo GIF (models/colliders.py): a dam
break splits around a cylinder standing in the run-out path while a
kinematic box plow sweeps in from the right.

    python scripts/make_obstacle_gif.py [--frames 120] [--out docs]

Runs on the default platform (the accelerator when there is one; pass --cpu for a
CPU render).  Uses the general path (colliders force the XLA grid
update anyway) at a small grid so the CPU render stays minutes.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from mpm_flip98a_tpu.config import MPMConfig, TransferKind
from mpm_flip98a_tpu.driver import Simulation
from mpm_flip98a_tpu.models import scenes
from mpm_flip98a_tpu.models.colliders import Collider


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out", default="docs")
    ap.add_argument("--dt", type=float, default=2e-5)
    ap.add_argument("--substeps", type=int, default=800)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    cfg = MPMConfig(
        dtype="float32", num_grids=65, dt=args.dt,
        flip_blend=0.98, transfer=TransferKind.PIC,
    )
    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    l = cfg.domain_length
    cylinder = Collider(
        kind="sphere", center=(0.45 * l, 0.09 * l), radius=0.07 * l
    )
    plow = Collider(
        kind="box",
        center=(0.95 * l, 0.10 * l),
        half_extents=(0.04 * l, 0.10 * l),
        sticky=True,
        center_velocity=(-0.35 * l, 0.0),
    )
    scene = dataclasses.replace(scene, colliders=(cylinder, plow))
    sim = Simulation(p, scene, path="general", out_dir=args.out, tag="obstacle")
    sim.run(n_frames=args.frames, substeps_per_frame=args.substeps, gif=True)
    src = f"{sim.frame_dir}/output.gif"
    dst = os.path.join(args.out, "obstacle.gif")
    os.replace(src, dst)
    print("wrote", dst)


if __name__ == "__main__":
    main()
