"""Closed-form small-matrix decompositions, vectorized over leading axes.

JAX replacement for the reference's scalar C++ routines
(reference: cpp_validation/taichi.h:8375-8419 — 2D polar decomposition and
the 2x2 SVD of Jiang et al., "Algorithm 4").  These run inside the fused
G2P/P2G kernels, so they are written as branch-free `jnp` expressions
(`jnp.where` instead of data-dependent control flow) that XLA fuses into the
surrounding elementwise work — no `lax.cond`, no host fallback.

All functions operate on arrays of shape (..., d, d) and are `vmap`/`jit`
friendly in fp32 and fp64.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def mm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched small-matrix product at full fp32/fp64 precision.

    An fp32 `a @ b` at default precision may run in reduced precision
    (TF32 on a GPU's tensor cores); for d x d (d = 2, 3) per-particle
    matrices that destroys the <= 1e-5 oracle agreement, so all hot-path
    matrix products go through here with precision='highest'."""
    return jnp.einsum("...ab,...bc->...ac", a, b, precision="highest")


def mv(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched matrix-vector product at full precision: (..., d, d) x (..., d)."""
    return jnp.einsum("...ab,...b->...a", a, b, precision="highest")


def det2x2(m: jax.Array) -> jax.Array:
    """Determinant of (..., 2, 2) (reference: taichi.h:7850)."""
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def det3x3(m: jax.Array) -> jax.Array:
    """Determinant of (..., 3, 3) (reference: taichi.h:7855)."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def det(m: jax.Array) -> jax.Array:
    d = m.shape[-1]
    if d == 2:
        return det2x2(m)
    if d == 3:
        return det3x3(m)
    return jnp.linalg.det(m)


def transpose(m: jax.Array) -> jax.Array:
    return jnp.swapaxes(m, -1, -2)


def polar_decomp_2d(m: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Closed-form 2D polar decomposition m = R S.

    R is the rotation nearest to m, built from the trace/skew pair
    (x, y) = (m00 + m11, m10 - m01); S = R^T m
    (reference: taichi.h:8375-8385).

    Returns (R, S), each (..., 2, 2).
    """
    x = m[..., 0, 0] + m[..., 1, 1]
    y = m[..., 1, 0] - m[..., 0, 1]
    scale = 1.0 / jnp.sqrt(x * x + y * y)
    c = x * scale
    s = y * scale
    r = jnp.stack(
        [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
    )
    s_mat = mm(transpose(r), m)
    return r, s_mat


def svd_2d(m: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Closed-form 2x2 SVD: m = U diag(sig) V^T.

    Polar decomposition followed by a single Jacobi rotation diagonalising
    the symmetric factor, with singular values ordered |sig0| >= |sig1|
    (Jiang et al. SVD notes, Algorithm 4; reference: taichi.h:8389-8419).
    Branches of the scalar algorithm become `jnp.where` selects.

    Returns (U, sig, V) with U, V (..., 2, 2) rotations and sig (..., 2).
    """
    u_p, s_m = polar_decomp_2d(m)
    s00 = s_m[..., 0, 0]
    s01 = s_m[..., 0, 1]
    s11 = s_m[..., 1, 1]

    # Jacobi rotation angle for the symmetric 2x2 [[s00, s01], [s01, s11]].
    off_diag_small = jnp.abs(s01) < jnp.asarray(1e-6, m.dtype)
    tao = 0.5 * (s00 - s11)
    w = jnp.sqrt(tao * tao + s01 * s01)
    # Guard the division for the off_diag_small branch (result discarded).
    denom = jnp.where(tao > 0, tao + w, tao - w)
    denom = jnp.where(off_diag_small, jnp.ones_like(denom), denom)
    t = s01 / denom
    c = jnp.where(off_diag_small, jnp.ones_like(t), 1.0 / jnp.sqrt(t * t + 1.0))
    s = jnp.where(off_diag_small, jnp.zeros_like(t), -t * c)

    sig0 = jnp.where(off_diag_small, s00, c * c * s00 - 2.0 * c * s * s01 + s * s * s11)
    sig1 = jnp.where(off_diag_small, s11, s * s * s00 + 2.0 * c * s * s01 + c * c * s11)

    # Order singular values: if sig0 < sig1 swap and rotate V by 90 degrees.
    swap = sig0 < sig1
    sig = jnp.stack(
        [jnp.where(swap, sig1, sig0), jnp.where(swap, sig0, sig1)], axis=-1
    )
    v00 = jnp.where(swap, -s, c)
    v01 = jnp.where(swap, -c, -s)
    v10 = jnp.where(swap, c, s)
    v11 = jnp.where(swap, -s, c)
    v_rows = jnp.stack(
        [jnp.stack([v00, v01], axis=-1), jnp.stack([v10, v11], axis=-1)], axis=-2
    )
    v = transpose(v_rows)
    u = mm(u_p, v)
    return u, sig, v


def polar_decomp_3d(m: jax.Array, iters: int = 12) -> Tuple[jax.Array, jax.Array]:
    """3D polar decomposition via scaled Newton iteration on the rotation factor.

    R_{k+1} = (gamma R_k + gamma^{-1} R_k^{-T}) / 2, which converges
    quadratically for the deformation gradients MPM produces (near identity,
    positive determinant).  Branch-free and fixed-trip-count so it fuses
    under jit.
    """
    r = m
    for _ in range(iters):
        r_inv_t = transpose(jnp.linalg.inv(r))
        # Frobenius scaling accelerates convergence.
        a = jnp.sqrt(jnp.sum(r_inv_t * r_inv_t, axis=(-2, -1)))
        b = jnp.sqrt(jnp.sum(r * r, axis=(-2, -1)))
        gamma = jnp.sqrt(a / jnp.maximum(b, jnp.finfo(m.dtype).tiny))[..., None, None]
        r = 0.5 * (gamma * r + r_inv_t / gamma)
    s = mm(transpose(r), m)
    # Symmetrise S against round-off.
    s = 0.5 * (s + transpose(s))
    return r, s


def svd_3d(m: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """3x3 SVD with rotation (det=+1) U and V, vectorized.

    Built on the polar decomposition + Jacobi eigendecomposition of the
    symmetric factor; used by 3D plasticity models.  For the weakly
    compressible fluid path only det(F) is needed, so this never appears in
    the fluid hot loop.
    """
    r, s = polar_decomp_3d(m)
    eigval, eigvec = jnp.linalg.eigh(s)  # ascending
    # Descending order to match the 2D convention.
    eigval = eigval[..., ::-1]
    eigvec = eigvec[..., ::-1]
    v = eigvec
    u = mm(r, v)
    return u, eigval, v


def polar_decomp(m: jax.Array) -> Tuple[jax.Array, jax.Array]:
    if m.shape[-1] == 2:
        return polar_decomp_2d(m)
    return polar_decomp_3d(m)


def svd(m: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    if m.shape[-1] == 2:
        return svd_2d(m)
    return svd_3d(m)


def inv2x2(m: jax.Array) -> jax.Array:
    """Closed-form inverse of (..., 2, 2)."""
    d = det2x2(m)
    inv = jnp.stack(
        [
            jnp.stack([m[..., 1, 1], -m[..., 0, 1]], axis=-1),
            jnp.stack([-m[..., 1, 0], m[..., 0, 0]], axis=-1),
        ],
        axis=-2,
    )
    return inv / d[..., None, None]


def inv3x3(m: jax.Array) -> jax.Array:
    """Closed-form adjugate inverse of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d_, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = jnp.stack(
        [
            jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], axis=-1),
            jnp.stack([f * g - d_ * i, a * i - c * g, c * d_ - a * f], axis=-1),
            jnp.stack([d_ * h - e * g, b * g - a * h, a * e - b * d_], axis=-1),
        ],
        axis=-2,
    )
    return co / det3x3(m)[..., None, None]


def inv(m: jax.Array) -> jax.Array:
    if m.shape[-1] == 2:
        return inv2x2(m)
    if m.shape[-1] == 3:
        return inv3x3(m)
    return jnp.linalg.inv(m)


def solve(a: jax.Array, b: jax.Array) -> jax.Array:
    """Solve a x = b for small d x d systems: (..., d, d) x (..., d).

    Used for the matrix-valued nodal mass of the penalty-EBC grid update
    (reference: fields.py:28 — 2x2 mass matrix per node)."""
    return mv(inv(a), b)


def outer(a: jax.Array, b: jax.Array) -> jax.Array:
    """Outer product over the trailing axis: (..., d) x (..., d) -> (..., d, d)
    (reference: taichi.h:7643)."""
    return a[..., :, None] * b[..., None, :]


def trace(m: jax.Array) -> jax.Array:
    return jnp.trace(m, axis1=-2, axis2=-1)


def eye_like(m: jax.Array) -> jax.Array:
    d = m.shape[-1]
    return jnp.broadcast_to(jnp.eye(d, dtype=m.dtype), m.shape)
