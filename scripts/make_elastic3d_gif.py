"""3D elastic-in-fluid drop demo GIF (multi-material fast3d path).

A neo-Hookean block falls onto a fluid slab at 64^3; frames are the
driver's material-colored orthographic projection.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mpm_flip98a_tpu.driver import Simulation
from mpm_flip98a_tpu.models import scenes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--substeps", type=int, default=400)
    ap.add_argument("--out", default="docs")
    args = ap.parse_args()

    p, scene = scenes.elastic_drop_3d(
        num_grids=64,
        fluid_particles=(48, 48, 16),
        block_particles=(16, 16, 16),
        dt=1e-5,
    )
    sim = Simulation(p, scene, path="fast", out_dir=args.out, tag="elastic_drop3d")
    # Manual frame loop: skip VTK (the GIF is the artifact) — the frame
    # bottleneck is the device->host pull + file IO, not compute.
    from mpm_flip98a_tpu.utils import render

    for i in range(args.frames):
        sim.step_frame(args.substeps)
        sim.post_process(write_vtk=False)
        print(f"frame {i + 1}/{args.frames}", flush=True)
    render.write_gif(sim.frames, f"{sim.frame_dir}/output.gif")
    dst = os.path.join(args.out, "elastic_drop3d.gif")
    os.replace(f"{sim.frame_dir}/output.gif", dst)
    print("wrote", dst)


if __name__ == "__main__":
    main()
