"""On-card smoke test: the main path end to end on one GPU.

    python chip_smoke.py            # one card: all single-card phases
    python chip_smoke.py --four     # four cards: the --devices paths only
    python chip_smoke.py --rehearse # tiny shapes, any backend (CPU rehearsal)

Phases, in this order (each one failing fails the script with a nonzero
exit; peak_bytes_in_use is process-wide, so they run from the smallest
footprint up and each phase's reading is its own):
  device     : the card as JAX and nvidia-smi report it; no CPU fallback
  cli        : `python -m mpm_flip98a_tpu` (driver.main, in this process)
               on the reference scene, fast and general paths
  fast2d     : 1M particles / 513^2 through driver.Simulation
  fast3d     : 8M particles / 256^3 through driver.Simulation
  transfers  : the fast paths' slot P2G / G2P at real widths against
               ops/transfer.p2g_scatter / g2p_gather on the dense
               particles and a float64 NumPy sum; fast vs general path
               (1 substep per particle, 200 substeps ensemble);
               models/mls_mpm vs the NumPy oracle for one substep
With --four only the sharded paths run: 2D --devices 4, 3D --devices 4 and
3D --devices 2x2, each against the one-card run of the same scene.

The last line of standard output is one JSON object
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}; it is
printed only when every phase passed.  Everything runs in this one process
(a JAX process reserves most of the card's memory).  `--report PATH`
also writes every check and timing as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

FULL = {
    "d2": dict(num_grids=513, num_particles_x=2000, num_particles_y=500,
               fluid_width=0.430, fluid_height=0.215, dt=2e-6),
    "d3": dict(num_grids=256, particles_per_axis=(512, 512, 32)),
    "d3_block_rows": 16,
    "ensemble_substeps": 200,
    "sim2d_substeps": 100,
    "sim3d_substeps": 20,
    "four_2d_substeps": 100,
    "four_3d_substeps": 40,
}
SMALL = {
    "d2": dict(num_grids=65, num_particles_x=64, num_particles_y=128,
               fluid_width=0.105, fluid_height=0.21, dt=1e-5),
    "d3": dict(num_grids=32, particles_per_axis=(48, 48, 8)),
    "d3_block_rows": 4,
    "ensemble_substeps": 20,
    "sim2d_substeps": 10,
    "sim3d_substeps": 4,
    "four_2d_substeps": 10,
    "four_3d_substeps": 4,
}
TOL_GRID = 1e-5    # per node and channel, relative to max |channel|
TOL_PATH = 1e-6    # fast vs general after 1 substep, per particle, relative
                   # to max |x| and max |v|
TOL_ENSEMBLE = 1e-5  # |d mean|, |d std| after the window: positions in m,
                     # velocities relative to max |v|
TOL_ORACLE = 1e-5  # mls_mpm (fp32) vs NumPy oracle, one substep, per field
                   # relative to max |field| (BASELINE parity)

REPORT: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, value: float, limit: float) -> None:
    ok = bool(value <= limit)
    REPORT.setdefault("checks", {})[name] = {"value": value, "limit": limit, "ok": ok}
    log(f"  {'PASS' if ok else 'FAIL'} {name}: {value:.3e} (limit {limit:.0e})")
    if not ok:
        raise AssertionError(f"{name}: {value} > {limit}")


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e!r})"


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------


def scene2d(sz):
    from mpm_flip98a_tpu.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu.models import scenes

    cfg = MPMConfig(dtype="float32", flip_blend=0.98, transfer=TransferKind.PIC, **sz["d2"])
    return scenes.dam_break_2d(cfg, dtype=np.float32)


def scene3d(sz):
    from mpm_flip98a_tpu.models import scenes

    return scenes.slab_3d(**sz["d3"])


def with_ids(p):
    """Particle ids ride in the material field: a single-fluid scene never
    reads it, and the bucket state carries it through every rebucket."""
    import jax.numpy as jnp

    return dataclasses.replace(p, material=jnp.arange(p.n, dtype=jnp.int32))


def host_by_id(fast, state, n):
    """Active slots of a bucket state, reordered by particle id."""
    h = fast.to_host(state)
    ids = h["mat"].astype(np.int64)
    if not np.array_equal(np.sort(ids), np.arange(n)):
        raise AssertionError("particle ids lost or duplicated")
    order = np.argsort(ids)
    return {k: v[order] for k, v in h.items()}


def moving(p, seed):
    """`p` with particle ids and seeded random velocities (0.5 m/s): from
    rest, x + dt v rounds back to x in fp32 for many substeps, and a
    comparison of positions would compare nothing."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    v = jnp.asarray(rng.normal(scale=0.5, size=p.v.shape), jnp.float32)
    return with_ids(dataclasses.replace(p, v=v))


def dense_host(p):
    """Host fields of dense Particles in the to_host naming (x0, v0, ...)."""
    x, v = np.asarray(p.x), np.asarray(p.v)
    return {f"{k}{a}": arr[:, a] for k, arr in (("x", x), ("v", v)) for a in range(x.shape[1])}


def field(h, dim, key):
    """(n, dim) float64 array of the per-axis host fields x0, x1, ... (or
    v0, ...); float64 so that a float32 sum's order cannot show up as a
    difference of means."""
    return np.stack([h[f"{key}{a}"] for a in range(dim)], axis=-1).astype(np.float64)


def compare_per_particle(tag, got, ref, dim):
    """Host dicts ordered by particle id: |d x|/max|x| and |d v|/max|v|."""
    for f in ("x", "v"):
        r = field(ref, dim, f)
        rel = np.abs(field(got, dim, f) - r).max() / np.abs(r).max()
        check(f"{tag}, per particle |d{f}|/max|{f}|", float(rel), TOL_PATH)


def compare_ensemble(tag, got, ref, dim):
    """Mean and spread of positions (m) and velocities (relative to max |v|)."""
    for f in ("x", "v"):
        a, r = field(got, dim, f), field(ref, dim, f)
        lim = TOL_ENSEMBLE * (1.0 if f == "x" else float(np.abs(r).max()))
        check(f"{tag}, |d mean {f}|", float(np.abs(a.mean(0) - r.mean(0)).max()), lim)
        check(f"{tag}, |d std {f}|", float(np.abs(a.std(0) - r.std(0)).max()), lim)


# ---------------------------------------------------------------------------
# transfers and paths
# ---------------------------------------------------------------------------


def _np_weights(gx):
    """float64 quadratic B-spline stencil of (N, d) grid coordinates."""
    from mpm_flip98a_tpu.ops import weights as W

    d = gx.shape[1]
    offs = W.stencil_offsets(d)
    base = np.floor(gx - 0.5)
    fx = gx - base
    w = np.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2], 1)
    wst = np.ones((gx.shape[0], len(offs)))
    for a in range(d):
        wst *= w[:, offs[:, a], a]
    dpos = offs[None].astype(np.float64) - fx[:, None, :]
    return base.astype(np.int64), offs, wst, dpos


def transfer_check(tag, p, cfg, fast, spec, seed):
    """Slot P2G / G2P on the bucket layout vs dense scatter/gather vs a
    float64 NumPy sum, on `p` with seeded random v and C."""
    import jax
    import jax.numpy as jnp

    from mpm_flip98a_tpu.config import KernelKind
    from mpm_flip98a_tpu.models.stabilized import PAD
    from mpm_flip98a_tpu.ops import transfer

    d = cfg.dim
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(p.n, d)).astype(np.float32)
    c = (rng.normal(size=(p.n, d, d)) * 50.0).astype(np.float32)
    p = with_ids(dataclasses.replace(p, v=jnp.asarray(v), C=jnp.asarray(c)))
    b = jax.jit(lambda q: fast.from_particles(q, cfg, spec))(p)
    g = cfg.num_grids
    grid_shape = (g,) * d
    dx = float(cfg.dx)
    kind = KernelKind.BSPLINE
    xs = [getattr(b, f"x{a}") for a in range(d)]
    vs = [getattr(b, f"v{a}") for a in range(d)]
    nch = d + 1

    # Seeded random grid field, d channels: a smooth field would make the
    # velocity gradient a small difference of large taps, and its fp32
    # cancellation error would say nothing about the transfer.
    vel_np = rng.normal(size=grid_shape + (d,)).astype(np.float32)
    vel = jnp.asarray(vel_np)

    @jax.jit
    def slots(xs, vs, cm, mass, mask, vel):
        gx = [x * jnp.float32(cfg.inv_dx) + jnp.float32(PAD) for x in xs]
        st = transfer.slot_stencil(gx, mask > 0, kind)
        chans = [mass * va for va in vs] + [mass]
        aff = [tuple(mass * cm[a][e] for e in range(d)) for a in range(d)] + [None]
        return transfer.p2g_slots(st, chans, aff, grid_shape, dx), transfer.g2p_slots(st, vel, dx, kind)

    @jax.jit
    def dense(x, v, cmat, mass, vel):
        gx = x * jnp.float32(cfg.inv_dx) + jnp.float32(PAD)
        base = jnp.floor(gx - 0.5).astype(jnp.int32)
        st = transfer.slot_stencil([gx[:, a] for a in range(d)], jnp.ones(x.shape[0], bool), kind)
        dpos = st.dpos * dx
        mv = mass[:, None, None] * (
            v[:, None, :] + jnp.einsum("nab,nsb->nsa", cmat, dpos, precision="highest")
        )
        vals = st.wst[..., None] * jnp.concatenate(
            [mv, jnp.broadcast_to(mass[:, None, None], mv.shape[:2] + (1,))], -1
        )
        grid = transfer.p2g_scatter(vals, base, st.offsets, grid_shape)
        gath = st.wst[..., None] * transfer.g2p_gather(vel, base, st.offsets)
        return grid, jnp.sum(gath, axis=1)

    cm = [[getattr(b, f"C{a}{e}") for e in range(d)] for a in range(d)]
    g_slot, (sums_slot, c_slot) = slots(xs, vs, cm, b.mass, b.mask, vel)
    g_dense, sums_dense = dense(p.x.astype(jnp.float32), p.v, p.C, p.mass.astype(jnp.float32), vel)

    # Device-side grid comparison, per channel.
    scale = jnp.max(jnp.abs(g_dense.reshape(-1, nch)), axis=0)
    diff = jnp.max(jnp.abs((g_slot - g_dense).reshape(-1, nch)), axis=0)
    check(f"{tag} P2G slots vs p2g_scatter", float(jnp.max(diff / scale)), TOL_GRID)

    # float64 NumPy sum over the touched nodes only.
    gx = (np.asarray(p.x, np.float32) * np.float32(cfg.inv_dx) + np.float32(PAD)).astype(np.float64)
    base, offs, wst, dpos = _np_weights(gx)
    idx = base[:, None, :] + offs[None]
    flat = np.ravel_multi_index(tuple(idx[..., a] for a in range(d)), grid_shape).ravel()
    nodes, inv = np.unique(flat, return_inverse=True)
    m64 = np.asarray(p.mass, np.float64)
    c64 = np.asarray(p.C, np.float64)
    mv = m64[:, None, None] * (
        np.asarray(p.v, np.float64)[:, None, :] + np.einsum("nab,nsb->nsa", c64, dpos * dx)
    )
    vals = np.concatenate([mv, np.broadcast_to(m64[:, None, None], mv.shape[:2] + (1,))], -1)
    vals = (wst[..., None] * vals).reshape(-1, nch)
    ref = np.stack([np.bincount(inv, weights=vals[:, ch], minlength=len(nodes)) for ch in range(nch)], 1)
    got = np.asarray(jnp.asarray(g_slot).reshape(-1, nch)[jnp.asarray(nodes)], np.float64)
    rel = np.max(np.abs(got - ref), axis=0) / np.max(np.abs(ref), axis=0)
    check(f"{tag} P2G slots vs float64 NumPy", float(rel.max()), TOL_GRID)

    # G2P: slots vs dense gather (per particle, by id) vs float64 NumPy.
    hb = jax.device_get({
        "ids": b.mat, "mask": b.mask,
        "sums": sums_slot.reshape(b.mask.shape + (d,)),
        "c": c_slot.reshape(b.mask.shape + (d, d)),
    })
    live = hb["mask"] > 0
    ids = hb["ids"][live]
    s_slot = np.zeros((p.n, d), np.float32)
    s_slot[ids] = hb["sums"][live]
    c_slot = np.zeros((p.n, d, d), np.float32)
    c_slot[ids] = hb["c"][live]
    wv = wst[..., None] * vel_np.reshape(-1, d)[flat].astype(np.float64).reshape(p.n, -1, d)
    s_np = np.sum(wv, axis=1)
    c_np = (4.0 / (dx * dx)) * np.einsum("nsa,nsb->nab", wv, dpos * dx)
    scale = np.max(np.abs(s_np), axis=0)
    check(f"{tag} G2P slots vs g2p_gather", float(np.max(np.abs(s_slot - np.asarray(sums_dense)).max(0) / scale)), TOL_GRID)
    check(f"{tag} G2P slots vs float64 NumPy", float(np.max(np.abs(s_slot - s_np).max(0) / scale)), TOL_GRID)
    check(f"{tag} G2P velocity gradient vs float64 NumPy",
          float(np.abs(c_slot - c_np).max() / np.abs(c_np).max()), TOL_GRID)

    # Partition of unity: G2P of an all-ones field is 1 at every live slot.
    ones = jnp.ones(grid_shape + (1,), jnp.float32)
    gxs = [x * jnp.float32(cfg.inv_dx) + jnp.float32(PAD) for x in xs]
    pou, _ = jax.jit(
        lambda gxs, m: transfer.g2p_slots(transfer.slot_stencil(gxs, m > 0, kind), ones, dx, kind)
    )(gxs, b.mask)
    pou = np.asarray(pou).reshape(b.mask.shape)[live]
    check(f"{tag} partition of unity", float(np.abs(pou - 1.0).max()), TOL_GRID)


def block3d(p, cfg, rows):
    """Particles whose base row on axis 0 lies in a `rows`-row pencil
    block at the middle of the grid."""
    from mpm_flip98a_tpu.models.stabilized import PAD
    from mpm_flip98a_tpu.state import Particles

    x = np.asarray(p.x)
    r0 = np.floor(x[:, 0] * cfg.inv_dx + PAD - 0.5)
    lo = cfg.num_grids // 2 - rows // 2
    sel = np.nonzero((r0 >= lo) & (r0 < lo + rows))[0]
    import jax.numpy as jnp

    return Particles.init(jnp.asarray(x[sel]), volume0=float(np.asarray(p.volume0)[0]),
                          density=float(np.asarray(p.density)[0]))


def phase_transfers(sz):
    import jax
    import jax.numpy as jnp

    from mpm_flip98a_tpu.config import MLS88Config
    from mpm_flip98a_tpu.models import fast2d, fast3d, mls_mpm, stabilized
    from mpm_flip98a_tpu.oracle import advance, init_dam_break
    from mpm_flip98a_tpu.state import MLS88Particles

    p, scene = scene2d(sz)
    cfg = scene.cfg
    spec = fast2d.FastSpec.for_particles(cfg, p)
    log(f"  2D: {p.n} particles, {cfg.num_grids}^2 grid, capacity {spec.capacity}")
    transfer_check("2D", p, cfg, fast2d, spec, seed=0)

    p3, scene3 = scene3d(sz)
    pb = block3d(p3, scene3.cfg, sz["d3_block_rows"])
    spec3 = fast3d.FastSpec3D.for_particles(scene3.cfg, pb)
    log(f"  3D block: {pb.n} particles of {p3.n}, {scene3.cfg.num_grids}^3 grid, capacity {spec3.capacity}")
    transfer_check("3D", pb, scene3.cfg, fast3d, spec3, seed=1)
    del p3, pb

    # Fast vs general path, per particle after 1 substep, then ensemble
    # statistics over a longer window (per-particle gaps grow chaotically
    # after ~50 fp32 substeps).
    pm = moving(p, seed=2)
    b = fast2d.from_particles(pm, cfg, spec)
    fast1 = host_by_id(fast2d, jax.jit(lambda s: fast2d.substep(s, scene))(b), p.n)
    gen1 = jax.jit(lambda q: stabilized.substep(q, scene))(pm)
    compare_per_particle("2D fast vs general, 1 substep", fast1, dense_host(gen1), 2)
    n = sz["ensemble_substeps"]
    bn = fast2d.run(b, scene, spec, n)
    pn = stabilized.run(pm, scene, n)
    compare_ensemble(f"2D fast vs general, {n} substeps", fast2d.to_host(bn), dense_host(pn), 2)
    if int(np.asarray(bn.overflow)) != 0:
        raise AssertionError("overflow in the ensemble run")

    # BASELINE per-substep parity: models/mls_mpm vs the NumPy oracle.
    mcfg = MLS88Config()
    s = init_dam_break(n=2000, seed=0)
    step = jax.jit(mls_mpm.make_substep(mcfg))
    worst = 0.0
    for warm in (0, 50, 200):
        for _ in range(warm):
            s = advance(s, mcfg)
        ours = step(MLS88Particles(
            x=jnp.asarray(s.x), v=jnp.asarray(s.v), F=jnp.asarray(s.F),
            C=jnp.asarray(s.C), Jp=jnp.asarray(s.Jp),
        ))
        ref = advance(s, mcfg)
        for f in ("x", "v", "F", "C", "Jp"):
            r = np.asarray(getattr(ref, f))
            err = np.abs(np.asarray(getattr(ours, f)) - r).max() / np.abs(r).max()
            worst = max(worst, float(err))
    check("mls_mpm vs NumPy oracle, 1 substep, max |d|/max|field|", worst, TOL_ORACLE)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def check_state(tag, fast, state, p):
    h = fast.to_host(state)
    n_live = h["x0"].shape[0]
    if n_live != p.n:
        raise AssertionError(f"{tag}: {n_live} live slots for {p.n} particles")
    for k in ("x0", "x1", "v0", "v1", "J"):
        if not np.isfinite(h[k]).all():
            raise AssertionError(f"{tag}: non-finite {k}")
    ovf = int(np.asarray(state.overflow).sum())
    if ovf != 0:
        raise AssertionError(f"{tag}: overflow {ovf}")
    m0 = float(np.asarray(p.mass, np.float64).sum())
    dm = abs(float(h["mass"].astype(np.float64).sum()) - m0) / m0
    check(f"{tag} mass conservation |dm|/m", dm, 1e-6)


def memory_of(fn, *args) -> dict:
    ma = fn.lower(*args).compile().memory_analysis()
    if ma is None:
        return {}
    return {k: int(getattr(ma, k)) for k in (
        "temp_size_in_bytes", "argument_size_in_bytes", "output_size_in_bytes",
    ) if hasattr(ma, k)}


def run_sim(tag, sim, p, n_sub, kind, frames):
    """Cold frame (compile + run), then a timed warm frame; `frames` also
    writes each frame's PNG + VTK."""
    import jax

    fast = sim._fast
    t0 = time.perf_counter()
    sim.step_frame(n_sub)
    cold = time.perf_counter() - t0
    if frames:
        sim.post_process(keep_frame=False)
    t0 = time.perf_counter()
    sim.step_frame(n_sub)
    jax.block_until_ready(sim.state)
    warm = time.perf_counter() - t0
    if frames:
        sim.post_process(keep_frame=False)
        sim.drain_io()
    check_state(tag, fast, sim.state, p)
    rate = n_sub / warm
    peak = peak_bytes()
    REPORT[tag] = {
        "particles": p.n, "grid": sim.cfg.num_grids, "capacity": sim.spec.capacity,
        "substeps_per_s": rate, "first_frame_s": cold, "warm_frame_s": warm,
        "peak_bytes_in_use": peak,
    }
    log(f"  {kind}: {tag} {p.n} particles: {rate:.1f} substeps/s "
        f"(warm frame {warm:.3f} s; first frame incl. compile {cold:.1f} s), "
        f"peak_bytes_in_use {peak}")


def phase_fast2d(sz, kind, out):
    from mpm_flip98a_tpu.driver import Simulation
    from mpm_flip98a_tpu.models import fast2d

    p, scene = scene2d(sz)
    sim = Simulation(p, scene, path="fast", out_dir=out, io_async=True)
    n = sz["sim2d_substeps"]
    run_sim("fast2d", sim, p, n, kind, frames=True)
    REPORT["fast2d"]["memory_analysis"] = memory_of(fast2d.run, sim.state, scene, sim.spec, n)
    log(f"  fast2d.run memory_analysis: {REPORT['fast2d']['memory_analysis']}")


def phase_cli(out):
    from mpm_flip98a_tpu.driver import main

    for path in ("fast", "general"):
        d = os.path.join(out, f"cli_{path}")
        main(["--scenario", "dam2d_flip98", "--path", path, "--frames", "2",
              "--substeps", "100", "--out", d])
        files = {
            sub: sorted(os.listdir(os.path.join(d, sub))) for sub in os.listdir(d)
        }
        pngs = [f for fs in files.values() for f in fs if f.endswith(".png")]
        vtks = [f for fs in files.values() for f in fs if f.endswith(".vtk")]
        log(f"  cli --path {path}: {files}")
        if len(pngs) < 2 or len(vtks) < 2:
            raise AssertionError(f"cli --path {path}: missing frames {files}")


def phase_fast3d(sz, kind, out):
    from mpm_flip98a_tpu.driver import Simulation
    from mpm_flip98a_tpu.models import fast3d

    p, scene = scene3d(sz)
    sim = Simulation(p, scene, path="fast", out_dir=out, io_async=True)
    n = sz["sim3d_substeps"]
    run_sim("fast3d", sim, p, n, kind, frames=False)
    REPORT["fast3d"]["memory_analysis"] = memory_of(fast3d.run, sim.state, scene, sim.spec, n)
    log(f"  fast3d.run memory_analysis: {REPORT['fast3d']['memory_analysis']}")


# ---------------------------------------------------------------------------
# --four: the sharded paths against one card
# ---------------------------------------------------------------------------


def sharded_case(tag, p, scene, devices, n_sub, out):
    import jax

    from mpm_flip98a_tpu.driver import Simulation

    dim = scene.cfg.dim
    pm = moving(p, seed=3)
    one = Simulation(pm, scene, path="fast", out_dir=os.path.join(out, tag + "_1"))
    many = Simulation(pm, scene, path="fast", out_dir=os.path.join(out, tag + "_n"), devices=devices)
    placed = {s.device for s in many.state.x0.addressable_shards}
    log(f"  {tag}: shards on {sorted(str(d) for d in placed)}")
    if len(placed) != many.devices:
        raise AssertionError(f"{tag}: shards on {len(placed)} devices, want {many.devices}")
    fast = one._fast
    for sim in (one, many):
        sim.step_frame(1)
    compare_per_particle(f"{tag} sharded vs one card, 1 substep",
                         host_by_id(fast, many.state, p.n), host_by_id(fast, one.state, p.n), dim)
    for sim in (one, many):
        t0 = time.perf_counter()
        sim.step_frame(n_sub)
        jax.block_until_ready(sim.state)
        REPORT.setdefault(tag, {})[f"{sim.devices}_device_frame_s"] = time.perf_counter() - t0
    compare_ensemble(f"{tag} sharded vs one card, {n_sub + 1} substeps",
                     fast.to_host(many.state), fast.to_host(one.state), dim)
    check_state(tag, fast, many.state, p)


def phase_four(sz, out):
    p, scene = scene2d(sz)
    sharded_case("2D --devices 4", p, scene, 4, sz["four_2d_substeps"], out)
    p3, scene3 = scene3d(sz)
    sharded_case("3D --devices 4", p3, scene3, 4, sz["four_3d_substeps"], out)
    sharded_case("3D --devices 2x2", p3, scene3, (2, 2), sz["four_3d_substeps"], out)


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true", help="sharded paths on four cards")
    ap.add_argument("--rehearse", action="store_true", help="tiny shapes on any backend")
    ap.add_argument("--report", help="write the checks and timings to this JSON file")
    args = ap.parse_args()

    import jax

    from mpm_flip98a_tpu.utils import compile_cache, native_io

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    log(f"devices: {jax.devices()}")
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU (platform {dev.platform!r})", file=sys.stderr)
        return 1
    want = 4 if args.four else 1
    if device["count"] < want:
        print(f"chip_smoke: {device['count']} devices, need {want}", file=sys.stderr)
        return 1
    sz = SMALL if args.rehearse else FULL
    kind = dev.device_kind
    smi = nvidia_smi()
    try:
        import PIL

        pillow = PIL.__version__
    except ImportError:
        pillow = None
    REPORT.update(device=device, nvidia_smi=smi, pillow=pillow,
                  native_frame_io=native_io._load() is not None,
                  compile_cache=compile_cache.enable(), jax=jax.__version__)
    log(f"jax {jax.__version__}; compile cache {REPORT['compile_cache']}; "
        f"Pillow {pillow}; native frame IO {REPORT['native_frame_io']}")

    failed = []
    with tempfile.TemporaryDirectory() as out:
        phases = (
            [("four", lambda: phase_four(sz, out))] if args.four else [
                ("cli", lambda: phase_cli(out)),
                ("fast2d", lambda: phase_fast2d(sz, kind, out)),
                ("fast3d", lambda: phase_fast3d(sz, kind, out)),
                ("transfers", lambda: phase_transfers(sz)),
            ]
        )
        for name, fn in phases:
            log(f"[{name}]")
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:  # noqa: BLE001 — report every phase, fail at the end
                traceback.print_exc()
                failed.append(name)
            REPORT.setdefault("phase_s", {})[name] = time.perf_counter() - t0
            log(f"[{name}] {'FAILED' if name in failed else 'ok'} in {REPORT['phase_s'][name]:.1f} s")

    REPORT["failed"] = failed
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(REPORT, f, indent=1, default=str)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    log(smi)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
