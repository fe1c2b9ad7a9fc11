"""Produce the dam-break demo GIF (the reference's golden visual artifact,
output.gif README.md:29-31) with the fast path.

    python scripts/make_gif.py [--frames 150] [--out docs]
"""

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
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--out", default="docs")
    ap.add_argument("--dt", type=float, default=1e-5)
    args = ap.parse_args()

    # Reference scene geometry (config.py:30-39) at dt = 1e-5 (CFL ~ 0.1;
    # the reference's 1e-6 is 10x under the stability limit) so a 1.5 s
    # collapse is 150 frames x 1000 substeps.
    from mpm_flip98a_tpu.config import TransferKind

    cfg = dataclasses.replace(
        MPMConfig(dtype="float32", flip_blend=0.98, transfer=TransferKind.PIC),
        dt=args.dt,
    )
    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    sim = Simulation(p, scene, path="fast", out_dir=args.out, tag="dam_break")
    sim.run(n_frames=args.frames, gif=True)
    src = f"{sim.frame_dir}/output.gif"
    dst = os.path.join(args.out, "dam_break.gif")
    os.replace(src, dst)
    print("wrote", dst)


if __name__ == "__main__":
    main()
