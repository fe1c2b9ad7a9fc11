"""Rigid SDF colliders (models/colliders.py — extension).

Grid-velocity collision against static sphere / halfspace obstacles with
slip or sticky surfaces and an optional constant surface velocity.
Pinned: the projection algebra (approach removed, separation and
tangential motion kept, sticky pins to the surface velocity), agreement
of the fast Pallas path with the general XLA path, no material
penetration through an obstacle, conveyor dragging, and sharded-vs-
single-device equality.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp

from mpm_flip98a_tpu.config import MPMConfig, TransferKind
from mpm_flip98a_tpu.models import colliders as col, fast2d, scenes
from mpm_flip98a_tpu.models.stabilized import run as run_ref, substep as substep_ref

CFG = MPMConfig(
    dtype="float32",
    num_grids=37,
    dt=2e-5,
    flip_blend=0.98,
    transfer=TransferKind.PIC,
)


def test_project_slip_and_sticky_algebra():
    # One node inside a halfspace floor (outward normal +y).
    floor = col.Collider(kind="halfspace", center=(0.0, 0.0), normal=(0.0, 1.0))
    coords = [jnp.array([0.1]), jnp.array([-0.01])]  # below the surface
    # Approaching (vy < 0): normal removed, tangential kept.
    vx, vy = col.project([jnp.array([0.3]), jnp.array([-0.7])], coords, (floor,))
    np.testing.assert_allclose([float(vx[0]), float(vy[0])], [0.3, 0.0], atol=1e-7)
    # Separating (vy > 0): untouched.
    vx, vy = col.project([jnp.array([0.3]), jnp.array([0.4])], coords, (floor,))
    np.testing.assert_allclose([float(vx[0]), float(vy[0])], [0.3, 0.4], atol=1e-7)
    # Outside the solid: untouched.
    out = [jnp.array([0.1]), jnp.array([0.02])]
    vx, vy = col.project([jnp.array([-0.5]), jnp.array([-0.5])], out, (floor,))
    np.testing.assert_allclose([float(vx[0]), float(vy[0])], [-0.5, -0.5])
    # Sticky pins to the surface velocity.
    belt = dataclasses.replace(floor, sticky=True, velocity=(0.25, 0.0))
    vx, vy = col.project([jnp.array([-0.5]), jnp.array([-0.9])], coords, (belt,))
    np.testing.assert_allclose([float(vx[0]), float(vy[0])], [0.25, 0.0], atol=1e-7)
    # Slip conveyor: tangential RELATIVE velocity kept, approach removed.
    belt_slip = dataclasses.replace(floor, velocity=(0.25, 0.0))
    vx, vy = col.project([jnp.array([0.3]), jnp.array([-0.7])], coords, (belt_slip,))
    np.testing.assert_allclose([float(vx[0]), float(vy[0])], [0.3, 0.0], atol=1e-7)


def test_sphere_phi_normal():
    s = col.Collider(kind="sphere", center=(1.0, 2.0), radius=0.5)
    coords = [jnp.array([1.0, 1.6]), jnp.array([2.8, 2.0])]
    phi, n = col.phi_normal(s, coords)
    np.testing.assert_allclose(np.asarray(phi), [0.3, 0.1], atol=1e-7)
    np.testing.assert_allclose(np.asarray(n[0]), [0.0, 1.0], atol=1e-7)
    np.testing.assert_allclose(np.asarray(n[1]), [1.0, 0.0], atol=1e-7)


def test_spinner_surface_velocity():
    # Sticky spinning sphere (2D): a node inside on the +x axis must get
    # v = omega x r = (0, omega * rx); slip spinner keeps the tangential
    # RELATIVE velocity and removes approach only.
    s = col.Collider(
        kind="sphere", center=(1.0, 1.0), radius=0.5, sticky=True,
        angular=(2.0,),
    )
    coords = [jnp.array([1.3]), jnp.array([1.0])]  # rx=0.3, ry=0
    vx, vy = col.project([jnp.array([0.9]), jnp.array([-0.4])], coords, (s,))
    np.testing.assert_allclose([float(vx[0]), float(vy[0])], [0.0, 0.6], atol=1e-6)
    # Slip spinner at the same node: n = (1, 0); vrel = (0.9, -0.4-0.6);
    # vrel.n = 0.9 > 0 (separating) -> untouched, then +vsurf back.
    s2 = dataclasses.replace(s, sticky=False)
    vx, vy = col.project([jnp.array([0.9]), jnp.array([-0.4])], coords, (s2,))
    np.testing.assert_allclose([float(vx[0]), float(vy[0])], [0.9, -0.4], atol=1e-6)
    # Approaching (vx < 0): normal removed -> vx = 0, vy unchanged.
    vx, vy = col.project([jnp.array([-0.9]), jnp.array([-0.4])], coords, (s2,))
    np.testing.assert_allclose([float(vx[0]), float(vy[0])], [0.0, -0.4], atol=1e-6)
    # 3D cross product: omega = (0,0,2) at r = (0.3,0,0) -> v = (0,0.6,0).
    s3 = col.Collider(
        kind="sphere", center=(1.0, 1.0, 1.0), radius=0.5, sticky=True,
        angular=(0.0, 0.0, 2.0),
    )
    c3 = [jnp.array([1.3]), jnp.array([1.0]), jnp.array([1.0])]
    v3 = col.project(
        [jnp.array([0.1]), jnp.array([0.2]), jnp.array([0.3])], c3, (s3,)
    )
    np.testing.assert_allclose(
        [float(v3[0][0]), float(v3[1][0]), float(v3[2][0])],
        [0.0, 0.6, 0.0], atol=1e-6,
    )


def test_spinner_stirs_fluid():
    # A sticky spinning cylinder submerged in settled fluid must inject
    # angular momentum: mean tangential speed about its center rises.
    p, scene = scenes.dam_break_2d(CFG, dtype=np.float32)
    l = CFG.domain_length
    spin = col.Collider(
        kind="sphere", center=(0.20 * l, 0.12 * l), radius=0.06 * l,
        sticky=True, angular=(40.0,),
    )
    scene = dataclasses.replace(scene, colliders=(spin,))
    out = run_ref(p, scene, 300)
    x = np.asarray(out.x)
    v = np.asarray(out.v)
    assert np.isfinite(v).all()
    r = x - np.asarray(spin.center)
    rn = np.linalg.norm(r, axis=1)
    near = (rn > spin.radius) & (rn < 2.5 * spin.radius)
    assert near.sum() > 50
    # Tangential component along +omega direction (CCW): t = (-ry, rx)/|r|
    t = np.stack([-r[:, 1], r[:, 0]], 1) / rn[:, None].clip(1e-12)
    vt = (v * t).sum(1)
    assert vt[near].mean() > 0.01


def _obstacle_setup(sticky=False):
    p, scene = scenes.dam_break_obstacle_2d(CFG, dtype=np.float32, sticky=sticky)
    spec = fast2d.FastSpec.for_particles(scene.cfg, p, headroom=2.0)
    b = fast2d.from_particles(p, scene.cfg, spec)
    return p, scene, spec, b


def _sorted_xy(h):
    x = np.stack([h["x0"], h["x1"]], -1)
    return x[np.lexsort((x[:, 1], x[:, 0]))]


def test_collider_fast_matches_general_2d():
    # The fast path's XLA grid update (_grid_update2d) applies the same
    # collider projection as the general path.
    p, scene, spec, b = _obstacle_setup()
    b1 = fast2d.substep(b, scene)
    p1 = substep_ref(p, scene)
    x_r = np.asarray(p1.x)
    np.testing.assert_allclose(
        _sorted_xy(fast2d.to_host(b1)),
        x_r[np.lexsort((x_r[:, 1], x_r[:, 0]))],
        atol=1e-7,
    )
    # 100 substeps: the collider BC is DISCONTINUOUS (a node flips
    # in/out of phi <= 0), so one fp32 ulp of path difference can flip a
    # node in one path but not the other and the trajectories fork — the
    # chaos caveat (CLAUDE.md) with a step nonlinearity instead of a
    # Lyapunov horizon.  Pin the ensemble: all but ~1% of particles
    # bit-track at 1e-5 and no particle forks beyond 1e-2 (measured:
    # ~20/16900 fork to ~1e-3 by substep 100; the algebra itself is
    # pinned exact by the single-substep check above).
    b100 = fast2d.run(b, scene, spec, 100)
    p100 = run_ref(p, scene, 100)
    x_r = np.asarray(p100.x)
    diff = np.abs(
        _sorted_xy(fast2d.to_host(b100))
        - x_r[np.lexsort((x_r[:, 1], x_r[:, 0]))]
    ).max(1)
    assert np.quantile(diff, 0.99) < 1e-5, np.quantile(diff, 0.99)
    assert diff.max() < 1e-2, diff.max()
    assert int(b100.overflow) == 0


def test_no_penetration_through_sphere():
    # Let the dam-break front wash over the cylinder: no particle ends up
    # deep inside it (grid collision allows <~1 cell transient overlap).
    # General path — the physics is path-agnostic (fast-vs-general is
    # pinned above) and interpret-mode Pallas at 2000 substeps is too
    # slow for CI.
    cfg = dataclasses.replace(CFG, dt=4e-5)
    # Obstacle at 0.40 l: the front (~sqrt(2 g h) ~ 1.5 m/s) covers the
    # ~0.12 m to it within ~0.1 s; 5000 x 4e-5 = 0.2 s washes over it.
    p, scene = scenes.dam_break_obstacle_2d(
        cfg, dtype=np.float32, center_frac=(0.40, 0.10)
    )
    out = run_ref(p, scene, 5000)
    x = np.asarray(out.x)
    assert np.isfinite(x).all()
    c = scene.colliders[0]
    phi = np.sqrt(((x - np.asarray(c.center)) ** 2).sum(-1)) - c.radius
    assert phi.min() > -1.5 * scene.cfg.dx
    # The flow actually reached the obstacle (some particles near it).
    assert (phi < 3 * scene.cfg.dx).any()


def test_conveyor_drags_material():
    # Sticky halfspace "belt" floor just above the box floor moving in +x:
    # fluid resting on it must acquire positive mean x-velocity.
    p, scene = scenes.dam_break_2d(CFG, dtype=np.float32)
    l = CFG.domain_length
    belt = col.Collider(
        kind="halfspace",
        center=(0.0, 0.06 * l),
        normal=(0.0, 1.0),
        sticky=True,
        velocity=(0.3, 0.0),
    )
    scene = dataclasses.replace(scene, colliders=(belt,))
    out = run_ref(p, scene, 400)
    v = np.asarray(out.v)
    assert np.isfinite(v).all()
    assert v[:, 0].mean() > 0.02


def test_collider_sharded_matches_single():
    from mpm_flip98a_tpu.parallel import make_mesh
    from mpm_flip98a_tpu.parallel.fast_domain import (
        FastDomainSpec,
        distribute,
        make_run,
    )

    p, scene, spec1_, _ = _obstacle_setup()
    mesh = make_mesh(4)
    spec = FastDomainSpec.for_particles(scene.cfg, 4, p, headroom=2.0)
    b = distribute(p, scene.cfg, spec, mesh)
    out = make_run(scene, spec, mesh)(b, 60)
    spec1 = fast2d.FastSpec.for_particles(scene.cfg, p, headroom=2.0)
    ref = fast2d.run(
        fast2d.from_particles(p, scene.cfg, spec1), scene, spec1, 60
    )
    np.testing.assert_allclose(
        _sorted_xy(fast2d.to_host(out)),
        _sorted_xy(fast2d.to_host(ref)),
        atol=1e-5,
    )
    assert int(np.asarray(out.overflow).sum()) == 0


def test_projection_respects_collider_solid():
    # Unit: projecting with solid_extra pins collider-node velocities
    # bit-exactly and still kills the divergence in the surrounding fluid.
    from mpm_flip98a_tpu.models import projection

    from mpm_flip98a_tpu.models.stabilized import PAD

    g, dx = 48, 0.01
    lo, hi = int(PAD), g - 1 - int(PAD)
    rng = np.random.default_rng(3)
    m = np.zeros((g, g), np.float32)
    # Free surface: leave an air band above (axis 1).  A FULLY enclosed
    # box is a pure-Neumann problem whose compatibility condition a
    # random RHS violates — see test_enclosed_box_degrades_gracefully.
    m[lo + 1 : hi, lo + 1 : hi - 8] = 1.0
    v = rng.normal(size=(g, g, 2)).astype(np.float32) * (m > 0)[..., None]
    idx = np.indices((g, g))
    c = np.array([g / 2, g / 2])
    sphere = ((idx[0] - c[0]) ** 2 + (idx[1] - c[1]) ** 2) <= 6.0**2
    v2, q, _ = projection.project(
        jnp.asarray(v), jnp.asarray(m), 0.5, dx=dx, lo=lo, hi=hi,
        iters=300, tol=1e-6, solid_extra=jnp.asarray(sphere),
    )
    v2 = np.asarray(v2)
    np.testing.assert_array_equal(v2[sphere], v[sphere])
    fluid = (m > 0.5) & ~sphere
    core = fluid.copy()
    for a in range(2):
        core &= np.roll(fluid, 1, a) & np.roll(fluid, -1, a)
        core &= np.roll(~sphere, 1, a) & np.roll(~sphere, -1, a)
    div0 = np.asarray(projection.divergence_b(jnp.asarray(v), dx))[core]
    div1 = np.asarray(projection.divergence_b(jnp.asarray(v2), dx))[core]
    assert np.sqrt((div1**2).mean()) < 0.05 * np.sqrt((div0**2).mean())


def test_enclosed_box_degrades_gracefully():
    # A box COMPLETELY filled with fluid (no free surface) is a pure-
    # Neumann pressure problem: a random RHS violates the compatibility
    # condition sum(b)=0, the system is inconsistent, and naive CG walks
    # off along the null space (this produced 1e8 velocities before the
    # breakdown/divergence guards).  Pinned: the solve exits finite and
    # bounded instead of exploding.
    from mpm_flip98a_tpu.models import projection
    from mpm_flip98a_tpu.models.stabilized import PAD

    g, dx = 32, 0.01
    lo, hi = int(PAD), g - 1 - int(PAD)
    rng = np.random.default_rng(7)
    m = np.zeros((g, g), np.float32)
    m[lo + 1 : hi, lo + 1 : hi] = 1.0
    v = rng.normal(size=(g, g, 2)).astype(np.float32) * (m > 0)[..., None]
    v2, q, resid = projection.project(
        jnp.asarray(v), jnp.asarray(m), 0.5, dx=dx, lo=lo, hi=hi,
        iters=300, tol=1e-6,
    )
    v2 = np.asarray(v2)
    assert np.isfinite(v2).all()
    assert np.abs(v2).max() < 100.0 * np.abs(v).max(), np.abs(v2).max()
    assert np.isfinite(float(resid))


def test_collider_incompressible_fast_matches_general():
    # Integration: dam break over the cylinder WITH the incompressible
    # projection — general path stays finite and the fast path matches.
    cfg = dataclasses.replace(CFG, incompressible=True)
    p, scene = scenes.dam_break_obstacle_2d(cfg, dtype=np.float32)
    spec = fast2d.FastSpec.for_particles(scene.cfg, p, headroom=2.0)
    b = fast2d.from_particles(p, scene.cfg, spec)
    b40 = fast2d.run(b, scene, spec, 40)
    p40 = run_ref(p, scene, 40)
    x_r = np.asarray(p40.x)
    assert np.isfinite(x_r).all()
    np.testing.assert_allclose(
        _sorted_xy(fast2d.to_host(b40)),
        x_r[np.lexsort((x_r[:, 1], x_r[:, 0]))],
        atol=1e-5,
    )


def test_box_phi_normal():
    # 2D axis-aligned box, half-extents (0.3, 0.2) about (1, 1).
    b = col.Collider(kind="box", center=(1.0, 1.0), half_extents=(0.3, 0.2))
    # Outside a face / outside a corner / inside near the top face /
    # dead center (normal defined, nearest face = y since hy < hx).
    coords = [
        jnp.array([1.5, 1.6, 1.0, 1.0]),
        jnp.array([1.0, 1.6, 1.15, 1.0]),
    ]
    phi, n = col.phi_normal(b, coords)
    np.testing.assert_allclose(
        np.asarray(phi),
        [0.2, np.sqrt(0.3**2 + 0.4**2), -0.05, -0.2],
        atol=1e-7,
    )
    # Face point: +x normal.
    np.testing.assert_allclose(
        [float(n[0][0]), float(n[1][0])], [1.0, 0.0], atol=1e-7
    )
    # Corner point: diagonal normal.
    np.testing.assert_allclose(
        [float(n[0][1]), float(n[1][1])], [0.6, 0.8], atol=1e-6
    )
    # Inside near the top: +y (nearest face).
    np.testing.assert_allclose(
        [float(n[0][2]), float(n[1][2])], [0.0, 1.0], atol=1e-7
    )
    # Normals stay unit-ish everywhere (slip projection relies on it).
    mag = np.sqrt(np.asarray(n[0]) ** 2 + np.asarray(n[1]) ** 2)
    np.testing.assert_allclose(mag, 1.0, atol=1e-6)
    # 3D corner.
    b3 = col.Collider(
        kind="box", center=(0.0, 0.0, 0.0), half_extents=(1.0, 1.0, 1.0)
    )
    c3 = [jnp.array([1.3]), jnp.array([1.4]), jnp.array([1.0])]
    phi3, n3 = col.phi_normal(b3, c3)
    np.testing.assert_allclose(float(phi3[0]), 0.5, atol=1e-7)
    np.testing.assert_allclose(
        [float(x[0]) for x in n3], [0.6, 0.8, 0.0], atol=1e-6
    )


def test_box_step_blocks_flow():
    # Dam break against a box step standing on the floor: the front is
    # blocked (slower run-out than unobstructed) and nothing ends up deep
    # inside the step.
    cfg = dataclasses.replace(CFG, dt=4e-5)
    p, scene0 = scenes.dam_break_2d(cfg, dtype=np.float32)
    l = cfg.domain_length
    step = col.Collider(
        kind="box",
        center=(0.32 * l, 0.075 * l),
        half_extents=(0.06 * l, 0.075 * l),
    )
    scene = dataclasses.replace(scene0, colliders=(step,))
    n_sub = 8000  # 0.32 s: the (measured ~0.5-1 m/s) front passes the box
    out = run_ref(p, scene, n_sub)
    x = np.asarray(out.x)
    assert np.isfinite(x).all()
    # Exact box SDF on the final positions.
    q = np.abs(x - np.asarray(step.center)) - np.asarray(step.half_extents)
    qp = np.maximum(q, 0.0)
    phi = np.sqrt((qp**2).sum(-1)) + np.minimum(q.max(-1), 0.0)
    assert phi.min() > -1.5 * cfg.dx, phi.min()
    assert (phi < 3 * cfg.dx).any()  # the flow reached the step
    # Control without the step: much more material makes it past the
    # step's right edge (the obstructed flow must first overtop it).
    out0 = run_ref(p, scene0, n_sub)
    x0 = np.asarray(out0.x)
    past, past0 = (x[:, 0] > 0.40 * l).mean(), (x0[:, 0] > 0.40 * l).mean()
    assert past0 > past + 0.02, (past0, past)


def test_moving_halfspace_algebra():
    # Kinematic halfspace floor rising at +0.5 m/s: at t the surface sits
    # at y = 0.5 t; a node below it is inside; sticky pins the node to the
    # surface velocity INCLUDING the translation velocity.
    floor = col.Collider(
        kind="halfspace", center=(0.0, 0.0), normal=(0.0, 1.0),
        sticky=True, center_velocity=(0.0, 0.5),
    )
    coords = [jnp.array([0.1]), jnp.array([0.15])]
    # t = 0: surface at y=0, node at 0.15 is outside -> untouched.
    vx, vy = col.project(
        [jnp.array([0.3]), jnp.array([-0.7])], coords, (floor,), t=0.0
    )
    np.testing.assert_allclose([float(vx[0]), float(vy[0])], [0.3, -0.7])
    # t = 0.4: surface at y=0.2, node inside -> pinned to (0, 0.5).
    vx, vy = col.project(
        [jnp.array([0.3]), jnp.array([-0.7])], coords, (floor,), t=0.4
    )
    np.testing.assert_allclose(
        [float(vx[0]), float(vy[0])], [0.0, 0.5], atol=1e-7
    )
    # t=None keeps the geometry static (legacy callers).
    vx, vy = col.project(
        [jnp.array([0.3]), jnp.array([-0.7])], coords, (floor,)
    )
    np.testing.assert_allclose([float(vx[0]), float(vy[0])], [0.3, -0.7])
    # Slip moving sphere: approach measured RELATIVE to the translation.
    s = col.Collider(
        kind="sphere", center=(1.0, 1.0), radius=0.5,
        center_velocity=(2.0, 0.0),
    )
    # t = 0.25: center at (1.5, 1), node (1.9, 1) inside, n = (1, 0).
    c2 = [jnp.array([1.9]), jnp.array([1.0])]
    # Node at rest: vrel = (-2, 0) approaching -> normal removed,
    # restored +vsurf -> carried at (2, 0)... slip keeps tangential only:
    # vrel' = (0,0) -> v = (2, 0).
    vx, vy = col.project(
        [jnp.array([0.0]), jnp.array([0.0])], c2, (s,), t=0.25
    )
    np.testing.assert_allclose(
        [float(vx[0]), float(vy[0])], [2.0, 0.0], atol=1e-6
    )
    # Node already fleeing faster than the sphere: untouched.
    vx, vy = col.project(
        [jnp.array([3.0]), jnp.array([0.1])], c2, (s,), t=0.25
    )
    np.testing.assert_allclose(
        [float(vx[0]), float(vy[0])], [3.0, 0.1], atol=1e-6
    )


def _plow_scene(cfg, speed=2.0, start=0.50, sticky=True):
    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    l = cfg.domain_length
    plow = col.Collider(
        kind="sphere", center=(start * l, 0.10 * l), radius=0.10 * l,
        sticky=sticky, center_velocity=(-speed * l, 0.0),
    )
    return p, dataclasses.replace(scene, colliders=(plow,))


def test_kinematic_threading_exact():
    # The t0 + i dt indexing in run() must reproduce a manual substep
    # loop (general path; atol 1e-7 — jit fori_loop vs eager differ by
    # ~1 ulp fusion noise), and the fast path must agree with the
    # general path at a traced t where the moved collider overlaps fluid.
    # The spinner term makes the BC velocity field LINEAR in the center
    # position, so a mis-indexed t (t0-only, off-by-one, reset) shows up
    # as an O(omega * cvel * n dt) velocity error, far above tolerance.
    p, scene = _plow_scene(CFG)
    spin_plow = dataclasses.replace(scene.colliders[0], angular=(200.0,))
    scene = dataclasses.replace(scene, colliders=(spin_plow,))
    t0 = 0.123
    out_run = run_ref(p, scene, 30, t0)
    q = p
    for i in range(30):
        q = substep_ref(q, scene, t=t0 + i * CFG.dt)
    np.testing.assert_allclose(
        np.asarray(out_run.x), np.asarray(q.x), atol=1e-7
    )
    # v atol 1e-4: jit-vs-eager ulp noise reaches ~4e-6 on the ~8 m/s
    # spinner-adjacent nodes; a mis-indexed t would err at ~0.05-0.1.
    np.testing.assert_allclose(
        np.asarray(out_run.v), np.asarray(q.v), atol=1e-4
    )
    # At t = 0.19 the plow center sits at (0.50 - 2*0.19) l = 0.12 l —
    # inside the dam column; one substep, fast vs general, exact.
    t_hit = 0.19
    spec = fast2d.FastSpec.for_particles(scene.cfg, p, headroom=2.0)
    b = fast2d.from_particles(p, scene.cfg, spec)
    b1 = fast2d.substep(b, scene, t=jnp.float32(t_hit))
    p1 = substep_ref(p, scene, t=t_hit)
    x_r = np.asarray(p1.x)
    np.testing.assert_allclose(
        _sorted_xy(fast2d.to_host(b1)),
        x_r[np.lexsort((x_r[:, 1], x_r[:, 0]))],
        atol=1e-7,
    )
    # And the moved collider actually touched material (the BC fired).
    assert np.max(np.abs(np.asarray(p1.v) - np.asarray(substep_ref(p, scene).v))) > 1e-6


def test_plow_pushes_material():
    # A sticky cylinder sweeping left into the column must impart
    # leftward momentum and carry no particle deep inside itself.
    cfg = dataclasses.replace(CFG, dt=4e-5)
    p, scene = _plow_scene(cfg, speed=1.0, start=0.45)
    n_sub = 4000
    t_end = n_sub * cfg.dt  # 0.16 s: plow center ends at 0.29 l
    out = run_ref(p, scene, n_sub, 0.0)
    x = np.asarray(out.x)
    v = np.asarray(out.v)
    assert np.isfinite(x).all() and np.isfinite(v).all()
    c = scene.colliders[0]
    center_end = np.asarray(c.center) + np.asarray(c.center_velocity) * t_end
    phi = np.sqrt(((x - center_end) ** 2).sum(-1)) - c.radius
    # No deep penetration of the MOVED geometry (a static-evaluated BC
    # would leave a particle-filled hole at center_end).
    assert phi.min() > -1.5 * cfg.dx
    # The run-out front cannot be past the plow: the wall moved TOWARD
    # the incoming front, so nothing leaks right of its trailing edge.
    assert x[:, 0].max() < center_end[0] + c.radius + 2 * cfg.dx
    # Static-collider control, same horizon: the moving sticky plow
    # drives the pool leftward — total x-momentum is measurably lower
    # than with the identical collider standing still.
    p2, scene2 = _plow_scene(cfg, speed=0.0, start=0.45)
    out2 = run_ref(p2, scene2, n_sub, 0.0)
    v2 = np.asarray(out2.v)
    assert np.isfinite(v2).all()
    assert v[:, 0].mean() < v2[:, 0].mean() - 0.03, (
        v[:, 0].mean(), v2[:, 0].mean()
    )


def test_kinematic_sharded_matches_single():
    from mpm_flip98a_tpu.parallel import make_mesh
    from mpm_flip98a_tpu.parallel.fast_domain import (
        FastDomainSpec,
        distribute,
        make_run,
    )

    p, scene = _plow_scene(CFG, speed=2.0, start=0.28)
    t0 = 0.03  # plow center at 0.22 l: its edge overlaps the column edge
    mesh = make_mesh(4)
    spec = FastDomainSpec.for_particles(scene.cfg, 4, p, headroom=2.0)
    b = distribute(p, scene.cfg, spec, mesh)
    out = make_run(scene, spec, mesh)(b, 60, t0)
    spec1 = fast2d.FastSpec.for_particles(scene.cfg, p, headroom=2.0)
    ref = fast2d.run(
        fast2d.from_particles(p, scene.cfg, spec1), scene, spec1, 60, t0
    )
    np.testing.assert_allclose(
        _sorted_xy(fast2d.to_host(out)),
        _sorted_xy(fast2d.to_host(ref)),
        atol=1e-5,
    )
    assert int(np.asarray(out.overflow).sum()) == 0


def test_collider_fast_matches_general_3d():
    from mpm_flip98a_tpu.models import fast3d

    p, scene = scenes.slab_3d(
        num_grids=16, particles_per_axis=(10, 10, 6), dt=2e-5,
        height_frac=0.35,
    )
    l = scene.cfg.domain_length
    sphere = col.Collider(
        kind="sphere",
        center=(0.5 * l, 0.5 * l, 0.05 * l),
        radius=0.12 * l,
    )
    scene = dataclasses.replace(scene, colliders=(sphere,))
    spec = fast3d.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    b = fast3d.from_particles(p, scene.cfg, spec)
    b20 = fast3d.run(b, scene, spec, 20)
    p20 = run_ref(p, scene, 20)
    h = fast3d.to_host(b20)
    x_f = np.stack([h["x0"], h["x1"], h["x2"]], -1)
    x_r = np.asarray(p20.x)
    np.testing.assert_allclose(
        x_f[np.lexsort((x_f[:, 2], x_f[:, 1], x_f[:, 0]))],
        x_r[np.lexsort((x_r[:, 2], x_r[:, 1], x_r[:, 0]))],
        atol=1e-5,
    )


def test_kinematic_collider_fast_matches_general_3d():
    # A rising sphere pushes through the settled slab: exercises the
    # fast path's kinematic collider (fast3d._grid_update with the
    # traced time) against the general XLA path, which threads the same
    # t = t0 + i dt through stabilized.run.
    from mpm_flip98a_tpu.models import fast3d

    p, scene = scenes.slab_3d(
        num_grids=16, particles_per_axis=(10, 10, 6), dt=2e-5,
        height_frac=0.35,
    )
    l = scene.cfg.domain_length
    sphere = col.Collider(
        kind="sphere",
        center=(0.5 * l, 0.5 * l, -0.10 * l),
        radius=0.12 * l,
        center_velocity=(0.0, 0.0, 2.0),
    )
    scene = dataclasses.replace(scene, colliders=(sphere,))
    t0 = 0.01  # start with the sphere already brushing the slab bottom
    spec = fast3d.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    b = fast3d.from_particles(p, scene.cfg, spec)
    b20 = fast3d.run(b, scene, spec, 20, t0)
    p20 = run_ref(p, scene, 20, t0)
    h = fast3d.to_host(b20)
    x_f = np.stack([h["x0"], h["x1"], h["x2"]], -1)
    x_r = np.asarray(p20.x)
    np.testing.assert_allclose(
        x_f[np.lexsort((x_f[:, 2], x_f[:, 1], x_f[:, 0]))],
        x_r[np.lexsort((x_r[:, 2], x_r[:, 1], x_r[:, 0]))],
        atol=1e-5,
    )
    # The sphere actually moved into the slab (some particles got kicked).
    assert np.asarray(p20.v)[:, 2].max() > 0.05
