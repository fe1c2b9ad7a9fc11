"""Simulation driver — the JAX build of the reference entry point.

Reference: exec.py — `initialization()`, the outer frame loop with 10,000
substeps per frame (exec.py:20-26), `progressBar` (:28), `post_process`
writing movie frames + VTK (:29), and the end-of-run `Run Time` print
(:31-32).  Here each frame's substeps run on-device in one
`lax.fori_loop` call (one host round-trip per frame, exactly the
reference's batching), and post-processing is headless (utils/render,
utils/io_vtk).

Two execution paths:
  - "general": models/stabilized.py (any switch combination, 2D/3D, f64)
  - "fast"   : models/fast2d.py / fast3d.py (bucketed fp32 state;
               flagship fluid pipeline)

Scenarios: the five BASELINE.json configs are named here.

CLI:  python -m mpm_flip98a_tpu [--scenario dam2d] [--frames 30] ...
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np

from mpm_flip98a_tpu.config import MPMConfig, TransferKind
from mpm_flip98a_tpu.models import fast2d, fast3d, scenes, stabilized
from mpm_flip98a_tpu.utils import checkpoint as ckpt
from mpm_flip98a_tpu.utils import compile_cache, io_vtk, native_io, render
from mpm_flip98a_tpu.utils.progress import create_file_paths, progress_bar
from mpm_flip98a_tpu.utils.timing import Timers, ThroughputMeter, device_sync


def reference_scene(dtype=np.float64):
    """The exact reference workload (config.py:24-46): 8,450 particles,
    105^2 grid, dt = 1e-6, 10,000 substeps per 1e-2 s frame, 3 s total."""
    return scenes.dam_break_2d(dtype=dtype)


SCENARIOS = {
    # BASELINE.json configs[0]: the mls-mpm88-matched dam break is exercised
    # by the test suite (tests/test_mls_mpm_vs_oracle.py); this entry runs
    # the production-scale equivalent.
    "dam2d": lambda: reference_scene(),
    # FLIP blending pairs with the PIC (non-affine) scatter — the standard
    # FLIP transfer.  FLIP + APIC affine scatter double-counts the local
    # velocity field and blows up within ~0.5 s (measured).
    "dam2d_flip98": lambda: scenes.dam_break_2d(
        dataclasses.replace(
            MPMConfig(), flip_blend=0.98, transfer=TransferKind.PIC
        )
    ),
    "elastic_drop": lambda: scenes.elastic_drop_2d(),
    "dam3d": lambda: scenes.dam_break_3d(),
    # EXTENSION: incompressible dam break — Chorin projection instead of
    # the stiff EOS carrying incompressibility (models/projection.py).
    "dam2d_incompressible": lambda: scenes.dam_break_2d(
        dataclasses.replace(
            MPMConfig(), flip_blend=0.98, transfer=TransferKind.PIC,
            incompressible=True,
        )
    ),
    # PRODUCTION snow material (materials.SNOW): hardening-scaled fixed
    # corotated with tracked plastic volume Jp — the validation solver's
    # full snow model (mls-mpm88-explained.cpp:17-19,67-69,164-177) in
    # the production material system.
    "snow2d": lambda: scenes.snow_block_2d(),
    # Drucker-Prager elastoplastic sand (materials.SAND, extension):
    # column collapse to an angle-of-repose pile (Klar et al. 2016).
    "sand2d": lambda: scenes.sand_column_2d(),
    # Rigid SDF collider (models/colliders.py, extension): dam break
    # splitting around a cylinder in the run-out path.
    "dam2d_obstacle": lambda: scenes.dam_break_obstacle_2d(),
    # Kinematic collider: a cylinder sweeping through the pool at
    # constant velocity (center_velocity BC).
    "plow2d": lambda: scenes.plow_2d(),
    # 3D variant of the rigid-obstacle dam break.
    "dam3d_obstacle": lambda: scenes.dam_break_obstacle_3d(),
}


def flip_sweep_scenes(alphas=(0.0, 0.5, 0.95, 0.98, 1.0)):
    """BASELINE.json configs[1]: PIC/FLIP/APIC blend sweep on the dam-break.

    alpha = 0 keeps the APIC affine transfer; alpha > 0 uses the standard
    FLIP pairing with PIC scatter."""
    return {
        f"alpha={a}": scenes.dam_break_2d(
            dataclasses.replace(
                MPMConfig(),
                flip_blend=a,
                transfer=TransferKind.APIC if a == 0.0 else TransferKind.PIC,
            )
        )
        for a in alphas
    }


class Simulation:
    """Frame-loop driver around a (particles, scene) pair."""

    def __init__(
        self,
        particles,
        scene,
        path: str = "general",
        out_dir: str = "out",
        tag: Optional[str] = None,
        render_res: int = 512,
        devices: int = 1,
        io_async: bool = False,
    ):
        self.scene = scene
        self.cfg = scene.cfg
        self.path = path
        # `devices`: int N (1D slab mesh) or (n0, n1) (two-axis 3D mesh,
        # slabs x pencil columns — parallel/fast_domain3d.py).
        self.device_grid = devices if isinstance(devices, tuple) else None
        self.devices = (
            devices[0] * devices[1] if isinstance(devices, tuple) else devices
        )
        self.timers = Timers()
        mix = "mixed" if self.cfg.pressure_mixing_ratio > 0 else "pointwise"
        self.tag = tag or f"dt{self.cfg.dt:g}_{mix}"
        self.frame_dir, self.vtk_dir = create_file_paths(self.tag, out_dir)
        self.render_res = render_res
        self.frames = []
        self.io_async = io_async
        self._io_pool = None
        self._io_futures = []
        self._host_cache = None
        self.total_time = 0.0
        self.frame_count = 0
        self._last_respec_frame = 0
        if self.devices > 1:
            # Multi-chip slab decomposition — the flagship scaling path
            # (parallel/fast_domain*.py), reachable from the user entry
            # point like the reference's exec.py is for its single-GPU
            # run.  3D accepts a 2D device grid (slabs x pencil columns).
            if path != "fast":
                raise ValueError("--devices > 1 requires --path fast")
            from mpm_flip98a_tpu.parallel import make_mesh, make_mesh2
            from mpm_flip98a_tpu.parallel import fast_domain, fast_domain3d

            self._fast = fast3d if self.cfg.dim == 3 else fast2d
            self._domain_mod = (
                fast_domain3d if self.cfg.dim == 3 else fast_domain
            )
            if self.device_grid is not None:
                if self.cfg.dim != 3:
                    raise ValueError(
                        "--devices N0xN1 (two-axis mesh) is 3D-only; "
                        "2D shards over a 1D slab mesh"
                    )
                self.mesh = make_mesh2(*self.device_grid)
                self.spec = fast_domain3d.FastDomain3DSpec.for_particles(
                    self.cfg, self.device_grid, particles
                )
            elif self.cfg.dim == 3:
                self.mesh = make_mesh(self.devices)
                self.spec = fast_domain3d.FastDomain3DSpec.for_particles(
                    self.cfg, self.devices, particles
                )
            else:
                self.mesh = make_mesh(self.devices)
                self.spec = fast_domain.FastDomainSpec.for_particles(
                    self.cfg, self.devices, particles
                )
            self.state = self._domain_mod.distribute(
                particles, self.cfg, self.spec, self.mesh
            )
            self._sharded_run = self._domain_mod.make_run(
                scene, self.spec, self.mesh
            )
        elif path == "fast":
            # Dimension routing: the fast path has a 2D (row-bucket) and a
            # 3D (pencil-bucket) implementation; pick by cfg.dim so
            # `--path fast` works for dam3d too.
            self._fast = fast3d if self.cfg.dim == 3 else fast2d
            if self.cfg.dim == 3:
                self.spec = fast3d.FastSpec3D.for_particles(self.cfg, particles)
            else:
                self.spec = fast2d.FastSpec.for_particles(self.cfg, particles)
            self.state = self._fast.from_particles(particles, self.cfg, self.spec)
        else:
            self.state = particles
        self.meter = ThroughputMeter(particles.n, self.cfg.stencil_size)

    # -- state access ----------------------------------------------------

    def _host_state(self) -> dict:
        """Per-frame cached host pull of the fast-path bucket state:
        positions() + material_colors() both need it every frame."""
        if self._host_cache is None or self._host_cache[0] != self.frame_count:
            self._host_cache = (self.frame_count, self._fast.to_host(self.state))
        return self._host_cache[1]

    def positions(self) -> np.ndarray:
        if self.path == "fast":
            h = self._host_state()
            keys = ["x0", "x1", "x2"][: self.cfg.dim]
            return np.stack([h[k] for k in keys], axis=-1)
        return np.asarray(self.state.x)[:, : self.cfg.dim]

    def material_colors(self) -> np.ndarray:
        """Per-particle RGB by material id (fluid blue, solids in the
        reference's impact-block palette, mls-mpm88-explained.cpp:194,199)."""
        if self.path == "fast":
            mats = self._host_state()["mat"].astype(np.int64)
        else:
            mats = np.asarray(self.state.material)
        palette = np.array(
            [
                render._hex_rgb(c)
                # fluid blue, neo-hookean red, corotated amber,
                # snow white, sand ochre
                for c in (0x2986CC, 0xED553B, 0xF2B134, 0xEDEDF4, 0xC2A878)
            ],
            np.uint8,
        )
        return palette[np.clip(mats, 0, len(palette) - 1)]

    # -- stepping --------------------------------------------------------

    def step_frame(self, n_substeps: Optional[int] = None) -> None:
        n = n_substeps or self.cfg.substeps_per_frame
        t0 = time.perf_counter()
        # Kinematic colliders see simulation time: total_time is the
        # substep-count-accurate clock (and survives checkpoint resume).
        from mpm_flip98a_tpu.models import colliders as _col

        sim_t0 = (
            self.total_time
            if self.scene.colliders and _col.any_moving(self.scene.colliders)
            else None
        )
        with self.timers.scope("substeps", sync=None):
            if self.devices > 1:
                self.state = self._sharded_run(self.state, n, sim_t0)
            elif self.path == "fast":
                self.state = self._fast.run(
                    self.state, self.scene, self.spec, n, sim_t0
                )
            else:
                self.state = stabilized.run(self.state, self.scene, n, sim_t0)
            device_sync(self.state)
        self.meter.update(n, time.perf_counter() - t0)
        self.total_time += n * self.cfg.dt
        self.frame_count += 1

    def post_process(self, write_vtk: bool = True, keep_frame: bool = True) -> None:
        """Render + export the current frame (exec.py:29 equivalent).

        Production frame dumps (keep_frame=False, i.e. no GIF assembly)
        go through the native rasterizer/PNG/binary-VTK library
        (utils/native_io.py — the stb_image_write/Canvas role of the
        reference's native layer) and, when `io_async`, run on a writer
        thread so frame IO overlaps the next frame's substeps instead of
        sitting on the critical path.  The host pull itself stays on the
        main thread (it must see THIS frame's device state)."""
        with self.timers.scope("post_process"):
            x = self.positions()
            # Project keeping the gravity axis (the LAST axis) vertical:
            # (x0, x1) in 2D, (x0, x2) side view in 3D — a (x0, x1) top
            # view of a 3D scene hides the fall entirely.
            x2 = x[:, [0, x.shape[1] - 1]]
            colors = self.material_colors()
            png_path = f"{self.frame_dir}/{self.frame_count:05d}.png"
            vtk_path = f"{self.vtk_dir}/{self.frame_count:05d}.vtk"
            res, extent = self.render_res, self.cfg.domain_length

            def write_frame():
                if keep_frame or not native_io.frame_png(
                    png_path, x2, colors, res, extent
                ):
                    img = render.rasterize(
                        x2, res=res, extent=extent, colors=colors
                    )
                    render.write_png(img, png_path)
                    return img
                return None

            def write_all():
                img = write_frame()
                if write_vtk and not native_io.vtk_particles(vtk_path, x):
                    io_vtk.write_vtk_particles(vtk_path, x)
                return img

            if self.io_async and not keep_frame:
                self._submit_io(write_all)
            else:
                img = write_all()
                if keep_frame:
                    self.frames.append(img)

    def _maybe_respec(self) -> None:
        """Adaptive bucket-capacity re-spec (single-device fast path).

        Fast-path work is proportional to bucket CAPACITY (rows x slots),
        not occupancy: as the dam collapse spreads the reference workload
        from 14 dense rows (max 650/row -> capacity 1024) to 100 sparse
        ones (max 368/row), every substep pays for slots that stay dead,
        while rebucket fires only ~1/10k substeps.  Re-bucketing between
        frames into a capacity sized from CURRENT occupancy removes that
        dead work, and it shrinks state memory and rebucket cost too.

        Occupancy comes free from the frame's cached host pull (the same
        arrays post_process rendered — no extra device round trip).  Each
        NEW capacity costs one jit recompile (cached for repeats);
        shrink hysteresis (>= 37.5% smaller, >= 4 frames apart) keeps
        respecs to a handful per run.  Capacity GROWS with no hysteresis
        the moment the occupancy-sized capacity exceeds the current one —
        the in-run rebucket drops over-capacity particles into the
        overflow counter, so growing early keeps that invariant-0.  Sized
        from a same-state snapshot with headroom >= 1, the respec
        rebucket itself cannot overflow.  MPM_ADAPT_CAP=0 disables;
        MPM_HEADROOM sets the sizing headroom (default 1.5)."""
        if (
            self.path != "fast"
            or self.devices > 1
            or os.environ.get("MPM_ADAPT_CAP", "1") == "0"
        ):
            return
        h = self._host_state()
        g = self.cfg.num_grids
        if self.cfg.dim == 3:
            r0 = np.floor(
                h["x0"] * self.cfg.inv_dx + fast3d.PAD - 0.5
            ).astype(np.int64)
            r1 = np.floor(
                h["x1"] * self.cfg.inv_dx + fast3d.PAD - 0.5
            ).astype(np.int64)
            pair = np.clip(r0, 0, g - 1) * g + np.clip(r1, 0, g - 1)
            mx = int(np.bincount(pair, minlength=g * g).max())
            want = fast3d.capacity_for(mx)
        else:
            row = np.floor(
                h["x0"] * self.cfg.inv_dx + fast2d.PAD - 0.5
            ).astype(np.int64)
            mx = int(np.bincount(np.clip(row, 0, g - 1), minlength=g).max())
            want = fast2d.capacity_for(mx)
        cap = self.spec.capacity
        # Each respec to a NEW capacity is a jit recompile (an earlier run
        # with naive thresholds thrashed through 13 capacities).  The bands below
        # leave a wide stable region: sizing uses the standard headroom
        # (fill ~0.67 after a respec), GROW (overflow safety, no frame
        # hysteresis) fires at fill ~0.87 (capacity_for at 1.15 headroom
        # exceeds cap), SHRINK (perf, >= 4 frames apart) only for a
        # >= 37.5% reduction — occupancy must move ~30% to leave the
        # band, so a run settles into a handful of capacities.
        if self.cfg.dim == 3:
            grow = fast3d.capacity_for(mx, 1.15) > cap
        else:
            grow = fast2d.capacity_for(mx, 1.15) > cap
        shrink = (
            want <= int(cap * 0.625)
            and self.frame_count - self._last_respec_frame >= 4
        )
        if not (shrink or grow) or want == cap:
            return
        new_spec = dataclasses.replace(self.spec, capacity=want)
        self.state = self._fast.rebucket(self.state, self.cfg, new_spec)
        self.spec = new_spec
        self._last_respec_frame = self.frame_count
        self._host_cache = None  # layout changed (values are identical)

    def _submit_io(self, fn) -> None:
        import concurrent.futures as cf

        if self._io_pool is None:
            self._io_pool = cf.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="mpm-io"
            )
        # Bound the backlog (each pending frame pins a host position
        # snapshot) and surface writer exceptions promptly.
        pending = [f for f in self._io_futures if not f.done()]
        if len(pending) >= 4:
            cf.wait(pending, return_when=cf.FIRST_COMPLETED)
        done = [f for f in self._io_futures if f.done()]
        for f in done:
            f.result()  # re-raise writer errors on the main thread
            self._io_futures.remove(f)
        self._io_futures.append(self._io_pool.submit(fn))

    def drain_io(self) -> None:
        """Block until every queued frame write has finished (and re-raise
        any writer exception)."""
        for f in self._io_futures:
            f.result()
        self._io_futures.clear()

    def save_checkpoint(self, path: str) -> None:
        """Format by suffix: '*.npz' = single-file host-gather npz;
        anything else = per-shard Orbax DIRECTORY (pod-scale path: each
        chip serialises its own slices, no host gather)."""
        meta = {
            "total_time": self.total_time,
            "frame_count": self.frame_count,
            "path": self.path,
        }
        if path.endswith(".npz"):
            ckpt.save(path, self.state, meta=meta)
        else:
            ckpt.save_sharded(path, self.state, meta=meta)

    def restore_checkpoint(self, path: str) -> None:
        if not path.endswith(".npz") and os.path.isdir(path):
            # Orbax directory: restore straight onto the current state's
            # shardings (the freshly distributed template) — no gather.
            self.state = ckpt.load_sharded(path, self.state)
            meta = ckpt.load_sharded_meta(path)
        else:
            if self.path == "fast":
                state_type = (
                    fast3d.FluidBuckets3D if self.cfg.dim == 3 else fast2d.FluidBuckets
                )
            else:
                state_type = type(self.state)
            self.state = ckpt.load(path, state_type)
            if self.devices > 1:
                # Re-place the restored (host) bucket state onto the mesh —
                # axis 0 of every field is the slab axis.
                import jax
                from jax.sharding import NamedSharding, PartitionSpec as P

                pspec = P(("x", "y")) if self.device_grid is not None else P("x")
                sharding = NamedSharding(self.mesh, pspec)
                self.state = jax.tree.map(
                    lambda a: jax.device_put(a, sharding), self.state
                )
            meta = ckpt.load_meta(path)
        self.total_time = meta["total_time"]
        self.frame_count = meta["frame_count"]
        if self.path == "fast" and self.devices == 1:
            # A checkpoint written after an adaptive re-spec
            # (_maybe_respec) carries a bucket capacity different from
            # the fresh-scenario spec built in __init__ — re-derive the
            # spec from the restored state's actual slot shape, or the
            # first in-loop rebucket would change the while_loop carry
            # shape and fail to trace.
            k = self.state.x0.shape[-1]
            if k != self.spec.capacity:
                self.spec = dataclasses.replace(self.spec, capacity=k)
        self._host_cache = None  # restored state invalidates the frame cache

    def run(
        self,
        n_frames: Optional[int] = None,
        substeps_per_frame: Optional[int] = None,
        gif: bool = False,
        verbose: bool = True,
        checkpoint_every: Optional[int] = None,
    ) -> None:
        """The reference outer loop (exec.py:20-29) + Run Time print (:31).

        `checkpoint_every` frames writes a rolling restart point — the
        failure-recovery mechanism the reference lacks (SURVEY.md section 5:
        its only persisted state is frames + VTK dumps)."""
        n_frames = n_frames or self.cfg.num_frames
        t_begin = time.time()
        sim_total = n_frames * (substeps_per_frame or self.cfg.substeps_per_frame) * self.cfg.dt
        for _ in range(n_frames):
            self.step_frame(substeps_per_frame)
            if verbose:
                progress_bar(
                    self.total_time,
                    sim_total,
                    extra=f"{self.meter.substeps_per_sec:.0f} sub/s",
                )
            self.post_process(keep_frame=gif)
            self._maybe_respec()
            if checkpoint_every and self.frame_count % checkpoint_every == 0:
                self.save_checkpoint(f"{self.frame_dir}/restart.npz")
        with self.timers.scope("post_process"):
            self.drain_io()  # async writes must land inside Run Time
        if gif and self.frames:
            render.write_gif(self.frames, f"{self.frame_dir}/output.gif")
        if verbose:
            print("Run Time:", time.time() - t_begin)  # exec.py:31-32
            print(self.timers.summary())


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="MPM simulation driver")
    ap.add_argument("--scenario", default="dam2d_flip98", choices=sorted(SCENARIOS))
    ap.add_argument("--path", default="general", choices=["general", "fast"])
    def _devices(s: str):
        # "8" -> 1D slab mesh; "2x4" -> two-axis 3D mesh (slabs x pencils).
        if "x" in s:
            n0, n1 = s.split("x")
            return (int(n0), int(n1))
        return int(s)

    ap.add_argument(
        "--devices", type=_devices, default=1,
        help="shard the fast path over N devices (slab decomposition), "
        "or N0xN1 for the two-axis 3D mesh (slabs x pencil columns)",
    )
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--substeps", type=int, default=None)
    ap.add_argument("--out", default="out")
    ap.add_argument("--resume", default=None, help="checkpoint to restore")
    ap.add_argument("--checkpoint", default=None, help="write checkpoint at end")
    ap.add_argument(
        "--checkpoint-every", type=int, default=None, help="rolling restart every N frames"
    )
    ap.add_argument(
        "--gif", action="store_true",
        help="also assemble the frames into output.gif (needs Pillow)",
    )
    ap.add_argument(
        "--sync-io", action="store_true",
        help="write frames on the main thread (default: async writer "
        "thread overlaps frame IO with the next frame's substeps)",
    )
    args = ap.parse_args(argv)
    compile_cache.enable()

    p, scene = SCENARIOS[args.scenario]()
    sim = Simulation(
        p, scene, path=args.path, out_dir=args.out, devices=args.devices,
        io_async=not args.sync_io,
    )
    if args.resume:
        sim.restore_checkpoint(args.resume)
    sim.run(
        n_frames=args.frames,
        substeps_per_frame=args.substeps,
        gif=args.gif,
        checkpoint_every=args.checkpoint_every,
    )
    if args.checkpoint:
        sim.save_checkpoint(args.checkpoint)


if __name__ == "__main__":
    main()
