"""Particle data parallelism with a replicated (psum-merged) grid.

Particles are sharded over the mesh along their leading axis; every chip
runs the full substep against a local copy of the background grid, and the
raw P2G sums are merged with one `jax.lax.psum` before the grid
update.  The grid update and G2P then run redundantly on every chip —
cheap, because grid work is O(G^dim) while particle work is O(N).

This is the right decomposition when the grid is small relative to the
particle count (the reference workload: 105^2 grid, config.py:37, versus
millions of particles).  For large grids use `parallel/domain.py` (slab
decomposition + halo exchange), which communicates only O(halo) data.
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mpm_flip98a_tpu.models.stabilized import Scene, substep
from mpm_flip98a_tpu.state import Particles


def pad_particles(p: Particles, multiple: int) -> Particles:
    """Pad the particle set to a multiple with inert particles.

    Padding particles have zero mass and volume, so every scatter
    contribution vanishes; they sit mid-domain and advect harmlessly.
    Static shapes are non-negotiable under jit/shard_map, so capacity
    padding + zero-weighting is how ragged counts are handled.
    """
    n = p.n
    rem = (-n) % multiple
    if rem == 0:
        return p
    d = p.dim
    dt = p.x.dtype
    center = jnp.full((rem, d), 0.5 * 0.4375, dt)

    def pad(arr, fill=0.0):
        pad_block = jnp.full((rem,) + arr.shape[1:], fill, arr.dtype)
        return jnp.concatenate([arr, pad_block], axis=0)

    eye = jnp.broadcast_to(jnp.eye(d, dtype=dt), (rem, d, d))
    return Particles(
        x=jnp.concatenate([p.x, center], axis=0),
        v=pad(p.v),
        C=pad(p.C),
        F=jnp.concatenate([p.F, eye], axis=0),
        J=pad(p.J, 1.0),
        stress=pad(p.stress),
        material=pad(p.material),
        volume0=pad(p.volume0),
        mass=pad(p.mass),
        density=pad(p.density, 1.0),
        pressure=pad(p.pressure),
        div_v=pad(p.div_v),
        pou=pad(p.pou),
        consistency=pad(p.consistency),
        Jp=pad(p.Jp, 1.0),
    )


def shard_particles(p: Particles, mesh: Mesh, axis: str = "x") -> Particles:
    """Place a (padded) particle state sharded along the mesh axis."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), p)


def make_run(scene: Scene, mesh: Mesh, axis: str = "x"):
    """Build `run(p, n_substeps)` executing the stabilized substep with
    particles sharded over `mesh` and the grid merged by psum."""

    @partial(jax.jit, static_argnames=("n_substeps",))
    def run(p: Particles, n_substeps: int) -> Particles:
        def local(p_local: Particles) -> Particles:
            reduce = lambda t: jax.lax.psum(t, axis)

            def body(_, s):
                return substep(s, scene, grid_reduce=reduce)

            return jax.lax.fori_loop(0, n_substeps, body, p_local)

        return jax.shard_map(
            local, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis)
        )(p)

    return run
