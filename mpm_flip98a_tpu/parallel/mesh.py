"""Mesh helpers."""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None, axis_name: str = "x"
) -> Mesh:
    """1D device mesh over the grid-slab axis.

    MPM scales by spatial decomposition along one grid axis (SURVEY.md
    section 2.7).  The mesh is a plain device list: the halo exchange
    only talks to slab neighbours, and every device of one host reaches
    every other at the same rate.  make_mesh2 adds pencil columns
    (parallel/fast_domain3d.py 2-axis mode).
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def make_mesh2(
    n0: int, n1: int, axis_names: tuple = ("x", "y")
) -> Mesh:
    """2D device mesh (n0 x n1) for the two-axis 3D decomposition:
    axis 0 shards grid rows (slabs), axis 1 shards grid columns (pencil
    columns).  The device order follows the decomposition alone."""
    devs = jax.devices()
    assert len(devs) >= n0 * n1, (len(devs), n0, n1)
    return Mesh(np.asarray(devs[: n0 * n1]).reshape(n0, n1), axis_names)
