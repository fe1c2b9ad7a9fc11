"""Assemble a driver frame dump (mov_*/NNNNN.png) into the acceptance GIF.

The reference's acceptance artifact is the dam-break GIF assembled from
its frame dump (/root/reference/README.md:29-35, output.gif; ffmpeg
assembly mls-mpm88-explained.cpp:235).  The CLI assembles in-process
when run with --gif; this script does it post hoc from a PNG frame
directory (e.g. a long run whose wall time should be pure
simulation+IO).

Usage:
    python scripts/assemble_gif.py out/mov_dt1e-06_pointwise docs/media/dam2d.gif \
        [--stride 2] [--fps 30] [--scale 2]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir", help="driver --out dir (contains mov_*/)")
    ap.add_argument("dst", help="output GIF path")
    ap.add_argument("--stride", type=int, default=1, help="keep every Nth frame")
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument(
        "--scale", type=int, default=1,
        help="integer downscale factor to bound GIF size",
    )
    args = ap.parse_args()

    from PIL import Image

    movs = sorted(glob.glob(os.path.join(args.run_dir, "mov_*")))
    if not movs:
        sys.exit(f"no mov_* dir under {args.run_dir}")
    pngs = sorted(glob.glob(os.path.join(movs[0], "*.png")))[:: args.stride]
    if not pngs:
        sys.exit(f"no frames under {movs[0]}")
    ims = []
    for p in pngs:
        im = Image.open(p).convert("P", palette=Image.ADAPTIVE)
        if args.scale > 1:
            im = im.resize((im.width // args.scale, im.height // args.scale))
        ims.append(im)
    os.makedirs(os.path.dirname(args.dst) or ".", exist_ok=True)
    ims[0].save(
        args.dst,
        save_all=True,
        append_images=ims[1:],
        duration=int(1000 / args.fps) * args.stride,
        loop=0,
    )
    print(f"{args.dst}: {len(ims)} frames, "
          f"{os.path.getsize(args.dst) / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
