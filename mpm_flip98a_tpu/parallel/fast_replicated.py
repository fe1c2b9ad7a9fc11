"""Multi-chip execution of the bucketed fast path: particle data parallelism.

LEGACY fallback — superseded by the slab-sharded fast paths
(parallel/fast_domain.py / fast_domain3d.py), which move O(halo) bytes
per substep instead of this module's O(grid) all-reduce and are the
production multi-chip path (driver --devices routes them).  Kept for
two reasons: (a) it is the simplest correct multi-chip reference the
slab tests compare against conceptually, and (b) for tiny grids with
huge particle counts the single psum can still win.  Known limitation
(accepted for a legacy path, round-2 review weak #6): per-shard bucket
capacity is provisioned from t = 0 occupancy with no re-provisioning —
a shard whose round-robin share drifts into one grid row can overflow
where the domain-decomposed paths would rebucket; overflow is counted
and surfaces through the overflow != 0 invariant, never silently.

Each chip owns a round-robin share of the particles in its own full
(R, K_local) bucket layout; the per-chip P2G grid sums merge with one
`psum` and everything else (grid update, G2P, rebucketing) runs per chip
with zero further communication.  The transfers are unchanged — they run
per shard inside `shard_map` on the local K axis.

Communication per substep = one all-reduce of the (G, G, ch) grid sums
(5 MB at 512^2 fp32).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mpm_flip98a_tpu.config import MPMConfig
from mpm_flip98a_tpu.models import fast2d
from mpm_flip98a_tpu.models.stabilized import Scene
from mpm_flip98a_tpu.state import Particles


def distribute(
    p: Particles, cfg: MPMConfig, mesh: Mesh, axis: str = "x", headroom: float = 2.0
):
    """Round-robin particles over devices, bucket each share, concatenate
    along the slot (K) axis and place sharded.  Returns (buckets, spec)
    where spec describes the LOCAL per-device layout."""
    n_dev = mesh.shape[axis]
    shares = [
        jax.tree.map(lambda a: a[d::n_dev], p) for d in range(n_dev)
    ]
    # One spec covering the worst share keeps shapes uniform.
    specs = [
        fast2d.FastSpec.for_particles(cfg, s, headroom=headroom) for s in shares
    ]
    cap = max(s.capacity for s in specs)
    spec = fast2d.FastSpec(rows=cfg.num_grids, capacity=cap)
    bs = [fast2d.from_particles(s, cfg, spec) for s in shares]
    merged = jax.tree.map(
        lambda *leaves: (
            jnp.concatenate(leaves, axis=1)
            if leaves[0].ndim == 2
            else jnp.stack(leaves)  # overflow scalars -> (n_dev,)
        ),
        *bs,
    )
    sharding_k = NamedSharding(mesh, P(None, axis))
    sharding_s = NamedSharding(mesh, P(axis))
    placed = fast2d.FluidBuckets(
        **{
            f: jax.device_put(
                getattr(merged, f),
                sharding_k if getattr(merged, f).ndim == 2 else sharding_s,
            )
            for f in merged.__dataclass_fields__
        }
    )
    return placed, spec


def make_run(scene: Scene, spec: fast2d.FastSpec, mesh: Mesh, axis: str = "x"):
    """Build `run(buckets, n_substeps)` over the mesh."""

    in_spec = fast2d.FluidBuckets(
        **{
            f: (P(None, axis) if f != "overflow" else P(axis))
            for f in fast2d.FluidBuckets.__dataclass_fields__
        }
    )

    @partial(jax.jit, static_argnames=("n_substeps",))
    def run(b: fast2d.FluidBuckets, n_substeps: int) -> fast2d.FluidBuckets:
        def local(bl: fast2d.FluidBuckets) -> fast2d.FluidBuckets:
            reduce = lambda t: jax.lax.psum(t, axis)

            def body(_, st):
                st = jax.lax.cond(
                    fast2d._needs_rebucket(st, scene.cfg),
                    lambda s: fast2d.rebucket(s, scene.cfg, spec),
                    lambda s: s,
                    st,
                )
                return fast2d.substep(st, scene, grid_reduce=reduce)

            return jax.lax.fori_loop(0, n_substeps, body, bl)

        # check_vma=False: everything here is trivially per-shard.
        return jax.shard_map(
            local, mesh=mesh, in_specs=(in_spec,), out_specs=in_spec,
            check_vma=False,
        )(b)

    return run


def collect_positions(b: fast2d.FluidBuckets) -> np.ndarray:
    h = fast2d.to_host(b)
    return np.stack([h["x0"], h["x1"]], axis=-1)
