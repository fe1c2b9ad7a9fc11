"""Per-substep agreement: JAX MLS-MPM solver vs NumPy oracle.

The BASELINE.json north-star correctness requirement: the JAX solver's 2D
dam-break matches the cpp_validation/mls-mpm88 reference per substep to
1e-5 in fp32.  Tested as (a) single-substep operator agreement from fresh
and mid-simulation states, and (b) trajectory agreement over hundreds of
substeps (chaotic divergence bounds the horizon; tolerances widen with
step count).
"""

import numpy as np
import jax.numpy as jnp

from mpm_flip98a_tpu.config import MLS88Config
from mpm_flip98a_tpu.oracle import advance, init_dam_break
from mpm_flip98a_tpu.models import mls_mpm
from mpm_flip98a_tpu.state import MLS88Particles

CFG = MLS88Config()


def _to_jax(s):
    return MLS88Particles(
        x=jnp.asarray(s.x),
        v=jnp.asarray(s.v),
        F=jnp.asarray(s.F),
        C=jnp.asarray(s.C),
        Jp=jnp.asarray(s.Jp),
    )


def _max_err(a: MLS88Particles, b) -> dict:
    return {
        "x": float(np.abs(np.asarray(a.x) - b.x).max()),
        "v": float(np.abs(np.asarray(a.v) - b.v).max()),
        "F": float(np.abs(np.asarray(a.F) - b.F).max()),
        "C": float(np.abs(np.asarray(a.C) - b.C).max()),
        "Jp": float(np.abs(np.asarray(a.Jp) - b.Jp).max()),
    }


def test_single_substep_matches_oracle_fp32():
    s = init_dam_break(n=2000, seed=0)
    substep = mls_mpm.make_substep(CFG)
    # Fresh state and states after 50/200 oracle steps (mid-collapse, with
    # boundary contact and plasticity active).
    for warmup in (0, 50, 200):
        for _ in range(warmup):
            s = advance(s, CFG)
        ours = substep(_to_jax(s))
        ref = advance(s, CFG)
        errs = _max_err(ours, ref)
        for k, e in errs.items():
            assert e <= 1e-5, f"substep mismatch after warmup={warmup}: {k}={e:.2e} ({errs})"


def test_trajectory_matches_oracle_300_steps_fp64():
    # fp32 trajectories diverge chaotically from scatter-order reassociation
    # alone (the dynamics amplify 1e-7 per-step noise by ~1e6 over 300
    # steps), so the long-horizon check runs in fp64 where the per-step
    # operator agreement is ~1e-15 and 300-step drift stays tiny.
    s = init_dam_break(n=1000, seed=2, dtype=np.float64)
    p = _to_jax(s)
    substep = mls_mpm.make_substep(CFG)
    worst = 0.0
    for step in range(300):
        s = advance(s, CFG)
        p = substep(p)
        if step % 50 == 49:
            err = _max_err(p, s)
            worst = max(worst, err["x"], err["v"])
    # Observed ~1.4e-5: per-step ~1e-12 reassociation noise amplified ~1e7x
    # by the contact dynamics — three orders tighter than the fp32 run,
    # i.e. the gap closes with precision exactly as operator agreement implies.
    assert worst <= 5e-4, f"trajectory diverged: {worst:.2e}"


def test_trajectory_statistics_match_fp32():
    # fp32 long-horizon check is statistical: the ensemble (center of mass,
    # dispersion) of the chaotic dam-break must agree even when individual
    # particle tracks decorrelate.
    s = init_dam_break(n=1000, seed=5)
    p = _to_jax(s)
    substep = mls_mpm.make_substep(CFG)
    for _ in range(300):
        s = advance(s, CFG)
        p = substep(p)
    com_ref = s.x.mean(axis=0)
    com_ours = np.asarray(p.x).mean(axis=0)
    np.testing.assert_allclose(com_ours, com_ref, atol=2e-3)
    np.testing.assert_allclose(
        np.asarray(p.x).std(axis=0), s.x.std(axis=0), atol=2e-3
    )


def test_run_fori_loop_equals_python_loop():
    s = init_dam_break(n=500, seed=3)
    p = _to_jax(s)
    substep = mls_mpm.make_substep(CFG)
    p_loop = p
    for _ in range(20):
        p_loop = substep(p_loop)
    p_fori = mls_mpm.run(p, CFG, 20)
    np.testing.assert_allclose(p_fori.x, p_loop.x, atol=1e-7)
    np.testing.assert_allclose(p_fori.v, p_loop.v, atol=1e-7)


def test_fp64_also_matches():
    s = init_dam_break(n=500, seed=4, dtype=np.float64)
    substep = mls_mpm.make_substep(CFG)
    ours = substep(_to_jax(s))
    ref = advance(s, CFG)
    errs = _max_err(ours, ref)
    for k, e in errs.items():
        assert e <= 1e-12, f"{k}={e:.2e}"
