"""Pure-functional simulation state pytrees.

The JAX replacement for the reference's mutable Taichi field groups
(reference: fields.py:4-51).  Every field group becomes a frozen dataclass of
`jnp` arrays registered as a JAX pytree, so whole states flow through `jit`,
`lax.fori_loop`, `shard_map` and checkpointing untouched.

Layout is structure-of-arrays with the leading axis = particle index (or grid
node index), which is what vectorized kernels want; small per-particle
matrices are trailing (..., d, d) axes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_pytree_dataclass
class MLS88Particles:
    """Particle state of the validation model
    (reference: cpp_validation/mls-mpm88-explained.cpp:28-42).

    x : (N, d)   position
    v : (N, d)   velocity
    F : (N, d, d) deformation gradient
    C : (N, d, d) APIC affine velocity matrix
    Jp: (N,)     plastic volume ratio determinant
    """

    x: jax.Array
    v: jax.Array
    F: jax.Array
    C: jax.Array
    Jp: jax.Array

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @staticmethod
    def init(x: jax.Array, v: Optional[jax.Array] = None) -> "MLS88Particles":
        n, d = x.shape
        dt = x.dtype
        eye = jnp.broadcast_to(jnp.eye(d, dtype=dt), (n, d, d))
        return MLS88Particles(
            x=x,
            v=jnp.zeros((n, d), dt) if v is None else v.astype(dt),
            F=eye,
            C=jnp.zeros((n, d, d), dt),
            Jp=jnp.ones((n,), dt),
        )


@_pytree_dataclass
class Particles:
    """Full particle state of the stabilized solver
    (reference: fields.py:4-21 ``ParticleFields``).

    Required:
      x, v          : (N, d)      position / velocity           (fields.py:6-7)
      C             : (N, d, d)   velocity gradient (APIC)      (fields.py:8)
      F             : (N, d, d)   deformation gradient          (fields.py:9)
      J             : (N,)        det(F)                        (fields.py:10)
      stress        : (N, d, d)   Cauchy stress                 (fields.py:11)
      material      : (N,) int32  material id                   (fields.py:12)
      volume0       : (N,)        initial particle volume       (fields.py:13)
      mass          : (N,)        particle mass                 (fields.py:14)
      density       : (N,)        particle density              (fields.py:21)
      pressure      : (N,)        particle pressure             (fields.py:19)
      div_v         : (N,)        velocity divergence           (fields.py:20)
      Jp            : (N,)        plastic volume ratio — SNOW hardening
                                  state (reference validation solver
                                  mls-mpm88-explained.cpp:37,172-177;
                                  inert 1.0 for non-snow materials)

    Diagnostics (kernel-consistency self checks, fields.py:15-18):
      pou           : (N,)        partition of unity  (sum of weights)
      consistency   : (N, d)      linear-field reproduction error
    """

    x: jax.Array
    v: jax.Array
    C: jax.Array
    F: jax.Array
    J: jax.Array
    stress: jax.Array
    material: jax.Array
    volume0: jax.Array
    mass: jax.Array
    density: jax.Array
    pressure: jax.Array
    div_v: jax.Array
    pou: jax.Array
    consistency: jax.Array
    Jp: jax.Array

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @staticmethod
    def init(
        x: jax.Array,
        *,
        volume0,
        density,
        material: Optional[jax.Array] = None,
        v: Optional[jax.Array] = None,
    ) -> "Particles":
        n, d = x.shape
        dt = x.dtype
        volume0 = jnp.broadcast_to(jnp.asarray(volume0, dt), (n,))
        density = jnp.broadcast_to(jnp.asarray(density, dt), (n,))
        eye = jnp.broadcast_to(jnp.eye(d, dtype=dt), (n, d, d))
        return Particles(
            x=x,
            v=jnp.zeros((n, d), dt) if v is None else v.astype(dt),
            C=jnp.zeros((n, d, d), dt),
            F=eye,
            J=jnp.ones((n,), dt),
            stress=jnp.zeros((n, d, d), dt),
            material=(jnp.zeros((n,), jnp.int32) if material is None else material.astype(jnp.int32)),
            volume0=volume0,
            mass=volume0 * density,
            density=density,
            pressure=jnp.zeros((n,), dt),
            div_v=jnp.zeros((n,), dt),
            pou=jnp.zeros((n,), dt),
            consistency=jnp.zeros((n, d), dt),
            Jp=jnp.ones((n,), dt),
        )


@_pytree_dataclass
class Grid:
    """Grid state of the stabilized solver (reference: fields.py:24-30).

    v       : (G..., d)     nodal velocity                    (fields.py:26)
    v0      : (G..., d)     pre-force velocity for FLIP delta  (fields.py:27)
    m       : (G..., d, d)  matrix-valued nodal mass           (fields.py:28)
                            — per-node d x d system so penalty-EBC normal
                            terms (k n(x)n) fold into the nodal solve
    volume  : (G...,)       nodal volume                       (fields.py:29)
    pressure: (G...,)       nodal pressure                     (fields.py:30)
    """

    v: jax.Array
    v0: jax.Array
    m: jax.Array
    volume: jax.Array
    pressure: jax.Array

    @staticmethod
    def zeros(grid_shape, dim: int, dtype) -> "Grid":
        return Grid(
            v=jnp.zeros(grid_shape + (dim,), dtype),
            v0=jnp.zeros(grid_shape + (dim,), dtype),
            m=jnp.zeros(grid_shape + (dim, dim), dtype),
            volume=jnp.zeros(grid_shape, dtype),
            pressure=jnp.zeros(grid_shape, dtype),
        )
