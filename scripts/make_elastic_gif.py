"""Elastic-in-fluid drop demo GIF (multi-material fast path)."""

import argparse
import dataclasses
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
    ap.add_argument("--dt", type=float, default=1e-5)
    args = ap.parse_args()

    cfg = dataclasses.replace(MPMConfig(dtype="float32"), dt=args.dt)
    p, scene = scenes.elastic_drop_2d(cfg, dtype=np.float32)
    sim = Simulation(p, scene, path="fast", out_dir=args.out, tag="elastic_drop")
    sim.run(n_frames=args.frames, gif=True)
    dst = os.path.join(args.out, "elastic_drop.gif")
    os.replace(f"{sim.frame_dir}/output.gif", dst)
    print("wrote", dst)


if __name__ == "__main__":
    main()
