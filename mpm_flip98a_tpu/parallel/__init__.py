"""Multi-chip execution: domain decomposition over a `jax.sharding.Mesh`.

The reference is strictly single-process / single-GPU (SURVEY.md section
2.7: no DP/TP/PP, no NCCL/MPI anywhere; Taichi kernel parallelism only).
This package *introduces* the MPM parallelism a multi-device run needs:

- `replicated` — particle data parallelism: particles sharded over chips,
  each chip scatters to a local full grid, one `psum` merges them.
  Simple and bandwidth-bound by grid size; right for small grids.
- `domain`     — spatial domain decomposition (the MPM analogue of
  data+context parallelism): the background grid is sliced into slabs
  along axis 0, P2G halo contributions and updated halo velocities ride
  `ppermute` neighbor exchanges, and particles migrate between
  neighbor shards with fixed-capacity buffers + validity masks
  (static shapes; SURVEY.md section 2.7).
"""

from mpm_flip98a_tpu.parallel.mesh import make_mesh, make_mesh2
