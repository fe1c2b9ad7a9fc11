"""16-device two-axis 3D decomposition (VERDICT r3 item 9).

The test session itself runs on the 8-device CPU mesh (conftest), so the
16-device coverage runs in a subprocess that pins its own virtual device
count before touching a backend (the same self-pinning pattern as
__graft_entry__.dryrun_multichip).  Exercises 16-device meshes: (4, 4)
and (8, 2) slabs x pencil columns, with both-axis halo exchange and
migration.
"""

import os
import subprocess
import sys

_SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 16)
import numpy as np
from mpm_flip98a_tpu.models import scenes, fast3d
from mpm_flip98a_tpu.parallel import make_mesh2
from mpm_flip98a_tpu.parallel import fast_domain3d

for (n0, n1) in [(4, 4), (8, 2)]:
    p, scene = scenes.slab_3d(
        num_grids=max(4 * n0, 4 * n1), particles_per_axis=(16, 16, 4),
        dt=1e-5,
    )
    mesh2 = make_mesh2(n0, n1)
    spec = fast_domain3d.FastDomain3DSpec.for_particles(
        scene.cfg, (n0, n1), p, headroom=2.0
    )
    b = fast_domain3d.distribute(p, scene.cfg, spec, mesh2)
    out = fast_domain3d.make_run(scene, spec, mesh2)(b, 2)
    assert int(np.asarray(out.overflow).sum()) == 0
    h = fast3d.to_host(out)
    assert np.isfinite(h["x0"]).all() and h["x0"].shape[0] == p.n
    print("OK", n0, n1, flush=True)
"""


def test_two_axis_3d_on_16_virtual_devices():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    env.setdefault("JAX_PLATFORMS", "cpu")
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        env=env, capture_output=True, text=True, timeout=2400,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, (out.stdout[-1000:], out.stderr[-2000:])
    assert out.stdout.count("OK") == 2, out.stdout
