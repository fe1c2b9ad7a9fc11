"""Rigid SDF colliders (extension beyond the reference's box walls).

The reference confines material with the padded box faces only
(cpp_validation/mls-mpm88-explained.cpp:122-128).  Production MPM needs
obstacles: this module adds rigid colliders defined by a signed distance
function — sphere, halfspace, and axis-aligned box — with slip or sticky
surfaces, constant surface velocity (conveyor) / angular velocity
(spinner) boundary conditions, and optional kinematic translation of the
geometry itself (center_velocity; see the Collider docstring).

Design: collision acts on GRID velocities (the classic MPM
grid-collision treatment), which is a pure elementwise projection over
node planes — no particle-side branching, no scatter, and it works
unchanged on slab-sharded buffers because it is pointwise (callers pass
global node coordinates for their shard window).  The same helper serves
every layout through broadcasting: the general path passes dense
(G, ..., d)-component arrays, the fast paths pass per-channel
(R, G)/(R0, R1, G2) planes with (R, 1)/(1, G)-shaped coordinates.

At a node with signed distance phi <= 0 and outward normal n:

    vrel = v - v_surface
    slip   : vrel' = vrel - min(vrel . n, 0) n   (remove approach only)
    sticky : vrel' = 0
    v      = vrel' + v_surface
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Collider:
    """Static rigid collider (hashable, jit-static — lives on Scene).

    kind      : 'sphere' | 'halfspace' | 'box'
    center    : sphere/box center / any point on the halfspace surface [m]
    radius    : sphere radius [m] (sphere only)
    half_extents : box half-widths per axis [m] (box only; axis-aligned)
    normal    : halfspace OUTWARD normal (pointing away from the solid;
                need not be normalized — it is normalized here)
    sticky    : sticky (True) or slip (False) surface
    velocity  : constant surface velocity [m/s] (conveyor BC)
    angular   : angular velocity about `center` [rad/s] — (omega_z,) in
                2D, (wx, wy, wz) in 3D; the surface velocity at a point
                is velocity + omega x (x - center) (spinner/mixer BC).
                The geometry itself is static — only the BC velocity
                field rotates, exact for rotationally symmetric shapes
                (spheres, or a halfspace spinning about its normal).
    center_velocity : constant velocity of the GEOMETRY [m/s] (kinematic
                collider): at simulation time t the effective center is
                center + center_velocity * t, and the surface velocity
                gains + center_velocity so material is carried, not
                passed through.  Callers thread t (run()'s t0 + i dt)
                into project()/inside_any(); t=None keeps the collider
                static regardless.
    """

    kind: str
    center: Tuple[float, ...]
    radius: float = 0.0
    half_extents: Tuple[float, ...] = ()
    normal: Tuple[float, ...] = ()
    sticky: bool = False
    velocity: Tuple[float, ...] = ()
    angular: Tuple[float, ...] = ()
    center_velocity: Tuple[float, ...] = ()

    def __post_init__(self):
        assert self.kind in ("sphere", "halfspace", "box"), self.kind
        if self.kind == "halfspace":
            assert len(self.normal) == len(self.center), self
        if self.kind == "box":
            assert len(self.half_extents) == len(self.center), self
        if self.velocity:
            assert len(self.velocity) == len(self.center), self
        if self.angular:
            d = len(self.center)
            assert len(self.angular) == (1 if d == 2 else 3), self
        if self.center_velocity:
            assert len(self.center_velocity) == len(self.center), self

    @property
    def moving(self) -> bool:
        return bool(self.center_velocity) and any(
            v != 0.0 for v in self.center_velocity
        )


def _center_at(c: Collider, dt_, t):
    """Per-axis effective center at simulation time t (scalar traced
    array or None = 0)."""
    d = len(c.center)
    if t is None or not c.moving:
        return [jnp.asarray(c.center[a], dt_) for a in range(d)]
    tt = jnp.asarray(t, dt_)
    return [
        jnp.asarray(c.center[a], dt_)
        + jnp.asarray(c.center_velocity[a], dt_) * tt
        for a in range(d)
    ]


def phi_normal(c: Collider, coords, t=None):
    """Signed distance (< 0 inside the solid) and outward normal at the
    broadcastable coordinate arrays `coords` (one per axis), with the
    geometry advected to simulation time `t` for kinematic colliders."""
    d = len(coords)
    dt_ = coords[0].dtype
    ctr = _center_at(c, dt_, t)
    if c.kind == "sphere":
        diff = [coords[a] - ctr[a] for a in range(d)]
        r = jnp.sqrt(sum(x * x for x in diff))
        r_safe = jnp.maximum(r, jnp.asarray(1e-12, dt_))
        n = [x / r_safe for x in diff]
        return r - jnp.asarray(c.radius, dt_), n
    if c.kind == "box":
        # Axis-aligned box, exact SDF: q_a = |x_a - c_a| - h_a;
        # phi = |max(q, 0)| + min(max_a q_a, 0).  Outward normal: outside,
        # the direction from the closest surface point; inside, the
        # nearest face's axis (one-hot on argmax q, sign of the offset).
        diff = [coords[a] - ctr[a] for a in range(d)]
        q = [
            jnp.abs(diff[a]) - jnp.asarray(c.half_extents[a], dt_)
            for a in range(d)
        ]
        qp = [jnp.maximum(x, 0.0) for x in q]
        out_len = jnp.sqrt(sum(x * x for x in qp))
        qmax = q[0]
        for a in range(1, d):
            qmax = jnp.maximum(qmax, q[a])
        phi = out_len + jnp.minimum(qmax, 0.0)
        # sign without 0 (nodes on a center plane still need a direction)
        sgn = [jnp.where(x >= 0, 1.0, -1.0).astype(dt_) for x in diff]
        safe_out = jnp.maximum(out_len, jnp.asarray(1e-12, dt_))
        face = [(q[a] >= qmax).astype(dt_) for a in range(d)]
        face_n = jnp.sqrt(sum(f * f for f in face))  # >= 1 (ties at edges)
        inside = qmax <= 0
        n = [
            jnp.where(
                inside, sgn[a] * face[a] / face_n, sgn[a] * qp[a] / safe_out
            )
            for a in range(d)
        ]
        return phi, n
    # halfspace: phi = n . (x - p), constant normal
    import math

    nn = math.sqrt(sum(x * x for x in c.normal))
    nu = [x / nn for x in c.normal]
    phi = sum(
        jnp.asarray(nu[a], dt_) * (coords[a] - ctr[a]) for a in range(d)
    )
    n = [jnp.broadcast_to(jnp.asarray(nu[a], dt_), phi.shape) for a in range(d)]
    return phi, n


def project(vs, coords, colliders: Tuple[Collider, ...], t=None):
    """Project per-component grid velocity arrays `vs` (list, one per
    axis, mutually broadcastable with the `coords` arrays) through every
    collider.  Returns the projected component list.  Pointwise — sharded
    callers pass global coordinates for their local window and need no
    halo.  `t` (traced scalar) advects kinematic colliders; their
    translation velocity joins the surface velocity."""
    d = len(vs)
    dt_ = vs[0].dtype
    for c in colliders:
        phi, n = phi_normal(c, coords, t)
        inside = phi <= 0
        vel = c.velocity or (0.0,) * d
        cvel = c.center_velocity or (0.0,) * d
        vsurf = [
            jnp.asarray(vel[a], dt_) + jnp.asarray(cvel[a], dt_)
            for a in range(d)
        ]
        if c.angular:
            # Spinner BC: v_surface += omega x (x - center(t)).
            ctr = _center_at(c, dt_, t)
            r = [coords[a] - ctr[a] for a in range(d)]
            if d == 2:
                w = jnp.asarray(c.angular[0], dt_)
                vsurf = [vsurf[0] - w * r[1], vsurf[1] + w * r[0]]
            else:
                wx, wy, wz = (jnp.asarray(w_, dt_) for w_ in c.angular)
                vsurf = [
                    vsurf[0] + wy * r[2] - wz * r[1],
                    vsurf[1] + wz * r[0] - wx * r[2],
                    vsurf[2] + wx * r[1] - wy * r[0],
                ]
        vrel = [vs[a] - vsurf[a] for a in range(d)]
        if c.sticky:
            proj = [jnp.zeros_like(v) for v in vrel]
        else:
            vn = sum(vrel[a] * n[a] for a in range(d))
            approach = jnp.minimum(vn, 0.0)
            proj = [vrel[a] - approach * n[a] for a in range(d)]
        vs = [
            jnp.where(inside, proj[a] + vsurf[a], vs[a]) for a in range(d)
        ]
    return vs


def inside_any(coords, colliders: Tuple[Collider, ...], t=None):
    """Boolean mask of nodes inside ANY collider (phi <= 0) — used by the
    incompressible projection to treat collider interiors as solid
    (Neumann) nodes in the pressure solve."""
    inside = None
    for c in colliders:
        phi, _ = phi_normal(c, coords, t)
        m = phi <= 0
        inside = m if inside is None else (inside | m)
    return inside


def any_moving(colliders: Tuple[Collider, ...]) -> bool:
    """Static predicate: does any collider's geometry move?  Callers skip
    time-threading entirely when False (bit-identical to the pre-kinematic
    build)."""
    return any(c.moving for c in colliders)


def node_coords(cfg, axis_indices, dtype=jnp.float32):
    """Physical node positions from grid indices: x = (idx - PAD) dx.
    `axis_indices` are broadcastable per-axis index arrays (global
    indices on sharded windows)."""
    from mpm_flip98a_tpu.models.stabilized import PAD

    return [
        (idx.astype(dtype) - jnp.asarray(PAD, dtype))
        * jnp.asarray(cfg.dx, dtype)
        for idx in axis_indices
    ]
