"""mpm_flip98a_tpu — a JAX Material Point Method framework.

A ground-up JAX/XLA re-design of the capabilities of the reference
repo `jeddiot/MPM-FLIP98A` (a stabilized MPM solver for free-surface flow):

- `config`    — physical + numerical configuration (reference: config.py)
- `state`     — pure-functional particle/grid state pytrees (reference: fields.py)
- `ops`       — transfer stencils (P2G/G2P) for dense particles and for
                bucket slots, 2x2/3x3 decompositions, row binning
- `models`    — material models (fixed corotated, neo-Hookean, weakly-compressible
                fluid) and the assembled MLS-MPM / stabilized-MPM substep pipelines
- `parallel`  — multi-chip domain decomposition: grid sharding over a
                `jax.sharding.Mesh`, halo exchange, particle migration
- `utils`     — IO (VTK, frames/GIF), checkpointing, progress, timing
- `oracle`    — NumPy port of the reference's C++ validation solver
                (cpp_validation/mls-mpm88-explained.cpp), the numerical
                ground truth for the test suite

Design: everything in the hot path is jit-compiled, statically shaped and
functional.  Substeps are batched on-device with `jax.lax.fori_loop` so host
overhead never appears (the reference runs 10,000 substeps per frame,
exec.py:21).  Multi-chip scaling uses `shard_map` + XLA collectives, not
host-side communication.
"""

__version__ = "0.1.0"

from mpm_flip98a_tpu import config as config
from mpm_flip98a_tpu import state as state
