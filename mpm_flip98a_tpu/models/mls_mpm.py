"""JAX MLS-MPM validation model: the JAX build of the reference C++ solver.

Reference: cpp_validation/mls-mpm88-explained.cpp:49-180.  Same pipeline —
P2G scatter of mass/momentum with the fused APIC + MLS-MPM stress affine
term, grid normalise + gravity + sticky/separating box boundaries, G2P
gather with APIC C reconstruction, advection, MLS F-update and the snow
plasticity singular-value clamp — expressed as one jit-compiled functional
substep over statically shaped arrays.

This model must match the NumPy oracle (`oracle/mls_mpm88_numpy.py`)
<= 1e-5 per substep in fp32 (BASELINE.json north star); the test suite
asserts exactly that.  `run()` batches substeps on-device with
`lax.fori_loop` so the 10k-substeps-per-frame pattern of the reference
driver (exec.py:21-26) costs one host round-trip per frame.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from mpm_flip98a_tpu.config import MLS88Config
from mpm_flip98a_tpu.ops import mathx
from mpm_flip98a_tpu.ops import weights as W
from mpm_flip98a_tpu.ops import transfer
from mpm_flip98a_tpu.state import MLS88Particles


def p2g(p: MLS88Particles, cfg: MLS88Config) -> jax.Array:
    """P2G scatter (reference: mls-mpm88-explained.cpp:53-102).

    Returns grid (G, G, 3) packing [m vx, m vy, m] (reference: :46-47).
    """
    dt = p.x.dtype
    offsets = W.stencil_offsets(cfg.dim)
    base, fx = W.base_and_fx(p.x, cfg.inv_dx)
    w_axes = W.quadratic_bspline(fx)                      # :60-64
    wst = W.stencil_weights(w_axes, offsets)              # (N, S)

    e = jnp.exp(cfg.hardening * (1.0 - p.Jp))             # :67
    mu = jnp.asarray(cfg.mu_0, dt) * e                    # :68
    lam = jnp.asarray(cfg.lambda_0, dt) * e               # :69
    j = mathx.det2x2(p.F)                                 # :72
    r, _ = mathx.polar_decomp_2d(p.F)                     # :74-76
    dinv = 4.0 * cfg.inv_dx * cfg.inv_dx                  # :79
    pf = (2.0 * mu)[:, None, None] * mathx.mm(p.F - r, mathx.transpose(p.F)) + (
        (lam * (j - 1.0) * j)[:, None, None] * jnp.eye(cfg.dim, dtype=dt)
    )                                                     # :81
    stress = -(cfg.dt * cfg.vol_p) * (dinv * pf)          # :84
    affine = stress + cfg.mass_p * p.C                    # :89

    dpos = W.stencil_dpos(fx, offsets) * jnp.asarray(cfg.dx, dt)   # :94
    mv = cfg.mass_p * p.v                                 # :96
    mom = mv[:, None, :] + jnp.einsum("nab,nsb->nsa", affine, dpos, precision="highest")  # :98
    mass = jnp.full(wst.shape + (1,), cfg.mass_p, dt)
    values = wst[..., None] * jnp.concatenate([mom, mass], axis=-1)
    return transfer.p2g_scatter(values, base, offsets, cfg.grid_shape)


def grid_update(grid: jax.Array, cfg: MLS88Config) -> jax.Array:
    """Normalise by mass, gravity, box boundaries
    (reference: mls-mpm88-explained.cpp:104-131)."""
    dt = grid.dtype
    m = grid[..., 2:3]
    has_mass = m > 0
    g = jnp.where(has_mass, grid / jnp.where(has_mass, m, 1.0), 0.0)   # :110
    g = g.at[..., 1].add(jnp.where(has_mass[..., 0], cfg.dt * cfg.gravity, 0.0))  # :113

    coords = jnp.arange(cfg.num_nodes, dtype=dt) / cfg.num_grid       # :118-119
    xg = coords[:, None]
    yg = coords[None, :]
    b = cfg.boundary
    sticky = (xg < b) | (xg > 1 - b) | (yg > 1 - b)                    # :122-124
    g = jnp.where(sticky[..., None], 0.0, g)
    sep = yg < b                                                       # :126-128
    g = g.at[..., 1].set(jnp.where(sep, jnp.maximum(0.0, g[..., 1]), g[..., 1]))
    return g


def g2p(p: MLS88Particles, grid: jax.Array, cfg: MLS88Config) -> MLS88Particles:
    """G2P gather + advection + MLS F-update + plasticity
    (reference: mls-mpm88-explained.cpp:133-179)."""
    dt = p.x.dtype
    offsets = W.stencil_offsets(cfg.dim)
    base, fx = W.base_and_fx(p.x, cfg.inv_dx)
    w_axes = W.quadratic_bspline(fx)
    wst = W.stencil_weights(w_axes, offsets)              # (N, S)
    dpos = W.stencil_dpos(fx, offsets)                    # :149 (grid units)

    gv = transfer.g2p_gather(grid[..., :2], base, offsets)  # (N, S, 2), :150
    wgv = wst[..., None] * gv
    new_v = jnp.sum(wgv, axis=1)                          # :153
    new_c = 4.0 * cfg.inv_dx * jnp.einsum("nsa,nsb->nab", wgv, dpos, precision="highest")  # :154

    new_x = p.x + cfg.dt * new_v                          # :159
    f_trial = mathx.mm(jnp.eye(cfg.dim, dtype=dt)[None] + cfg.dt * new_c, p.F)  # :162
    u, sig, v = mathx.svd_2d(f_trial)                     # :164-165
    if cfg.plastic:                                       # :167-170
        sig = jnp.clip(sig, 1.0 - 2.5e-2, 1.0 + 7.5e-3)
    old_j = mathx.det2x2(f_trial)                         # :172
    f_new = mathx.mm(u, sig[..., :, None] * mathx.transpose(v))  # :173
    jp_new = jnp.clip(p.Jp * old_j / mathx.det2x2(f_new), 0.6, 20.0)  # :175-177
    return MLS88Particles(x=new_x, v=new_v, F=f_new, C=new_c, Jp=jp_new)


def make_substep(cfg: MLS88Config) -> Callable[[MLS88Particles], MLS88Particles]:
    """Build the jit-compiled substep closure for a static config."""

    @jax.jit
    def substep(p: MLS88Particles) -> MLS88Particles:
        grid = p2g(p, cfg)
        grid = grid_update(grid, cfg)
        return g2p(p, grid, cfg)

    return substep


@partial(jax.jit, static_argnames=("cfg", "n_substeps"))
def run(p: MLS88Particles, cfg: MLS88Config, n_substeps: int) -> MLS88Particles:
    """Advance `n_substeps` on-device (reference driver pattern exec.py:21-26:
    10,000 substeps per host round-trip)."""

    def body(_, state):
        grid = p2g(state, cfg)
        grid = grid_update(grid, cfg)
        return g2p(state, grid, cfg)

    return jax.lax.fori_loop(0, n_substeps, body, p)


def init_dam_break(
    n: int = 3000, seed: int = 0, dtype=jnp.float32, cfg: MLS88Config = MLS88Config()
) -> MLS88Particles:
    """Reference scene: particles uniform in a 0.16 x 0.16 block at
    (0.13, 0.13) (reference: mls-mpm88-explained.cpp:191-201)."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, 2)) * 2.0 - 1.0) * 0.08 + np.array([0.13, 0.13])
    return MLS88Particles.init(jnp.asarray(x, dtype))
