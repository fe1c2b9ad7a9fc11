"""Configuration for the MPM framework.

Mirrors the parameter surface of the reference's ``config.py``
(reference: config.py:4-46) — the physical constants, the six feature
switches, and the derived grid geometry (including the 4 padding cells,
config.py:37-44) — as frozen, hashable dataclasses so they can be closed
over by ``jax.jit`` as static configuration.

Unlike the reference (mutable singletons created at import time with an
import-order coupling to ``ti.init``, config.py:69-71), configs here are
immutable values with derived quantities computed in ``__post_init__``;
no global state, no framework initialisation required.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import jax.numpy as jnp


class TransferKind(str, enum.Enum):
    """Velocity transfer scheme (reference: config.py:18 ``switch_vt_I_APIC``)."""

    PIC = "pic"
    APIC = "apic"


class KernelKind(str, enum.Enum):
    """Interpolation kernel (reference: config.py:21 ``switch_kernelFunction``).

    ``BSPLINE`` is the quadratic B-spline used by both the Python scaffold
    (support 1.5 dx, config.py:41-43) and the C++ validation solver
    (mls-mpm88-explained.cpp:60-64).  ``TENT`` is the linear hat function
    (support 1 dx) on the same 3-node stencil.
    """

    BSPLINE = "bspline"
    TENT = "tent"


class EOSKind(str, enum.Enum):
    """Equation of state for the weakly-compressible fluid pressure."""

    LINEAR = "linear"  # p = -K (J - 1)
    TAIT = "tait"      # p = (K/gamma) ((1/J)^gamma - 1), gamma = 7


@dataclasses.dataclass(frozen=True)
class Physics:
    """Physical constants of the fluid (reference: config.py:4-12).

    Derived moduli follow the reference's formulas exactly:
    E = 2K(1 - nu), G = K(1 - nu)/(1 + nu) (config.py:9-10).
    """

    dynamic_viscosity: float = 1e-3     # [Pa s]     config.py:6
    poissons_ratio: float = 4.999e-1    # unitless   config.py:7
    bulk_modulus: float = 2e6           # [Pa]       config.py:8
    particle_density: float = 997.5     # [kg/m^3]   config.py:11
    gravity: float = -9.81              # [m/s^2]    config.py:12

    @property
    def youngs_modulus(self) -> float:  # config.py:9
        return self.bulk_modulus * 2.0 * (1.0 - self.poissons_ratio)

    @property
    def shear_modulus(self) -> float:  # config.py:10
        return self.bulk_modulus * (1.0 - self.poissons_ratio) / (1.0 + self.poissons_ratio)

    def lame_parameters(self) -> Tuple[float, float]:
        """(mu, lam) from (E, nu), as in mls-mpm88-explained.cpp:25-26."""
        e, nu = self.youngs_modulus, self.poissons_ratio
        mu = e / (2.0 * (1.0 + nu))
        lam = e * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
        return mu, lam


@dataclasses.dataclass(frozen=True)
class MPMConfig:
    """Numerical settings (reference: config.py:15-46) plus framework-side knobs.

    The reference's boolean switch set is the feature matrix
    (SURVEY.md section 5): APIC/PIC (config.py:18), F-bar (:19), penalty
    EBC (:20), B-spline/tent (:21), pressure mixing ratio (:28), FLIP
    blend alpha (:29), dtype (:17), dimension (:22).
    """

    # -- discretisation -------------------------------------------------
    dim: int = 2                                  # config.py:22
    dtype: str = "float64"                        # config.py:17 (ti.f64)
    num_grids: int = 105                          # nodes per axis, config.py:37
    domain_length: float = 0.4375                 # [m] config.py:33
    dt: float = 1e-6                              # [s] config.py:26
    simulation_time: float = 3.0                  # [s] config.py:24
    frame_rate: float = 1e-2                      # [s] per frame, config.py:46

    # -- feature switches ----------------------------------------------
    transfer: TransferKind = TransferKind.APIC    # config.py:18
    kernel: KernelKind = KernelKind.BSPLINE       # config.py:21
    use_fbar: bool = False                        # config.py:19
    use_penalty_ebc: bool = False                 # config.py:20
    flip_blend: float = 0.0                       # alpha: 1=FLIP, 0=APIC/PIC, config.py:29
    pressure_mixing_ratio: float = 0.0            # 1=mixed, 0=pointwise, config.py:28
    eos: EOSKind = EOSKind.LINEAR
    # EXTENSION beyond the reference switch set: continuum-surface-force
    # surface tension [N/m] on the general path (0 = off).
    surface_tension: float = 0.0
    # EXTENSION: Chorin-style incompressible pressure projection on the
    # grid velocities (models/projection.py) — pair with a reduced
    # bulk_modulus to escape the weakly-compressible acoustic CFL.
    # General path, single device (the CG needs global reductions).
    incompressible: bool = False
    pressure_iters: int = 60                      # CG iteration cap
    pressure_tol: float = 1e-4                    # relative residual exit

    # -- penalty essential BCs ------------------------------------------
    penalty: float = 1e6                          # config.py:27

    # -- scene: dam-break fluid column ----------------------------------
    num_particles_x: int = 65                     # config.py:30
    num_particles_y: int = 130                    # config.py:31
    fluid_width: float = 0.057                    # [m] config.py:34
    fluid_height: float = 0.114                   # [m] config.py:35

    # -- kernel geometry ------------------------------------------------
    kernel_support_normalized: float = 1.5        # config.py:41

    numerical_tolerance: float = 1e-15            # config.py:23

    def __post_init__(self):
        # FLIP blending must pair with the PIC (non-affine) scatter: the
        # FLIP delta re-adds the local velocity field that the APIC affine
        # term already carried to the grid, double-counting it — measured
        # to diverge within ~0.5 s of simulated time on the dam-break.
        # The driver auto-pairs (driver.flip_sweep_scenes); reject the
        # combination here so no config silently runs unstable physics.
        if self.flip_blend > 0.0 and self.transfer == TransferKind.APIC:
            raise ValueError(
                "flip_blend > 0 requires transfer=TransferKind.PIC: the "
                "FLIP delta blend double-counts the APIC affine velocity "
                "field and diverges (pair alpha=0 with APIC instead)"
            )

    # ---- derived quantities (reference: config.py:32-46) --------------

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    @property
    def num_particles(self) -> int:               # config.py:32
        return self.num_particles_x * self.num_particles_y

    @property
    def num_cells(self) -> int:                   # config.py:38
        return self.num_grids - 1

    @property
    def dx(self) -> float:
        """Grid spacing; 4 cells pad outside the physical domain (config.py:39)."""
        return self.domain_length / float(self.num_cells - 4)

    @property
    def inv_dx(self) -> float:                    # config.py:40
        return 1.0 / self.dx

    @property
    def kernel_support(self) -> float:            # config.py:42
        return self.kernel_support_normalized * self.dx

    @property
    def nodes_in_support_1d(self) -> int:         # config.py:43
        return int(self.kernel_support * self.inv_dx * 2 + self.numerical_tolerance)

    @property
    def grid_node_shift(self) -> float:           # config.py:44
        return float(self.kernel_support_normalized - 1.0)

    @property
    def initial_particle_volume(self) -> float:   # config.py:36
        return (self.fluid_width * self.fluid_height) / self.num_particles

    def penalty_parameter(self, physics: Physics) -> float:  # config.py:45
        return self.penalty * physics.particle_density * self.dx ** 2

    @property
    def substeps_per_frame(self) -> int:          # exec.py:21
        return int(self.frame_rate // self.dt)

    @property
    def num_frames(self) -> int:                  # exec.py:20
        return int(math.ceil(self.simulation_time / self.frame_rate))

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return (self.num_grids,) * self.dim

    @property
    def stencil_size(self) -> int:
        """Nodes touched per particle: 3^dim for the quadratic B-spline."""
        return 3 ** self.dim

    def gravity_force(self, physics: Physics) -> Tuple[float, ...]:
        """Total gravity *force* on the fluid column, as the reference stores it
        (config.py:52: [0, W*H*rho*g]); solvers convert to acceleration by
        dividing by total fluid mass W*H*rho."""
        f = self.fluid_width * self.fluid_height * physics.particle_density * physics.gravity
        return (0.0,) * (self.dim - 1) + (f,)

    def gravity_acceleration(self, physics: Physics) -> Tuple[float, ...]:
        return (0.0,) * (self.dim - 1) + (physics.gravity,)


@dataclasses.dataclass(frozen=True)
class MLS88Config:
    """Configuration of the C++ validation solver
    (reference: cpp_validation/mls-mpm88-explained.cpp:8-26).

    Kept as a separate tiny config because the validation solver is its own
    material model (fixed corotated + snow plasticity, fp32) and is the
    per-substep ground truth for the test suite (SURVEY.md section 4).
    """

    num_grid: int = 80            # cells per axis (nodes = num_grid + 1), :9
    dt: float = 1e-4              # :11
    frame_dt: float = 1e-3        # :12
    mass_p: float = 1.0           # :17
    vol_p: float = 1.0            # :18
    hardening: float = 1.0        # :19
    youngs_modulus: float = 1e2   # :20
    poissons_ratio: float = 0.499 # :21
    plastic: bool = True          # :22
    gravity: float = -200.0       # :113
    boundary: float = 0.05        # :116
    dim: int = 2

    @property
    def dx(self) -> float:        # :13
        return 1.0 / self.num_grid

    @property
    def inv_dx(self) -> float:    # :14
        return 1.0 * self.num_grid

    @property
    def mu_0(self) -> float:      # :25
        return self.youngs_modulus / (2.0 * (1.0 + self.poissons_ratio))

    @property
    def lambda_0(self) -> float:  # :26
        e, nu = self.youngs_modulus, self.poissons_ratio
        return e * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))

    @property
    def num_nodes(self) -> int:
        return self.num_grid + 1

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return (self.num_nodes,) * self.dim
