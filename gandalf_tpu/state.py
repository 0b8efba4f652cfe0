"""Particle state: structure-of-arrays pytrees.

The reference stores particles as arrays-of-structs (`Particle<ndim>`,
src/Headers/Particle.h:133-223) with trimmed per-loop proxy structs.  The
device layout is the transpose: one jax array per field (SoA), so every
hot loop is a fused vector op and per-kernel "proxies" are just field
selections.  Fixed capacity + dead mask replaces dynamic allocation.

`SphState` carries the same physical fields as `GradhSphParticle`
(Particle.h:233-368): r, v, a and their step-start copies r0/v0/a0, m, h,
rho, u/u0, dudt/dudt0, pressure, sound, invomega, zeta, hfactor, div_v,
alpha (time-dependent artificial viscosity), gpot, plus integer block-time
step bookkeeping (level, levelneib, nlast/tlast) and status flags.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

# particle types (reference src/Headers/Particle.h:43)
GAS_TYPE = 0
ICM_TYPE = 1
CDM_TYPE = 2
DUST_TYPE = 3
BOUNDARY_TYPE = 4

# status flag bits (reference src/Headers/Flags.h:29-60, same layout)
FLAG_DEAD = 1 << 0
FLAG_ACTIVE = 1 << 1
FLAG_END_TIMESTEP = 1 << 2
FLAG_POTMIN = 1 << 3
FLAG_UPDATE_DENSITY = 1 << 4     # meshless
FLAG_BAD_GRADIENTS = 1 << 5      # meshless
FLAG_X_PERIODIC_LHS = 1 << 7
FLAG_Y_PERIODIC_LHS = 1 << 8
FLAG_Z_PERIODIC_LHS = 1 << 9
FLAG_X_PERIODIC_RHS = 1 << 10
FLAG_Y_PERIODIC_RHS = 1 << 11
FLAG_Z_PERIODIC_RHS = 1 << 12
FLAG_X_MIRROR_LHS = 1 << 13
FLAG_Y_MIRROR_LHS = 1 << 14
FLAG_Z_MIRROR_LHS = 1 << 15
FLAG_X_MIRROR_RHS = 1 << 16
FLAG_Y_MIRROR_RHS = 1 << 17
FLAG_Z_MIRROR_RHS = 1 << 18


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SphState:
    """SoA grad-h SPH particle state (+ global time scalars)."""

    # kinematics: shape (N, ndim)
    r: Array
    v: Array
    a: Array
    r0: Array
    v0: Array
    a0: Array
    # scalars per particle: shape (N,)
    m: Array
    h: Array
    rho: Array
    u: Array
    u0: Array
    dudt: Array
    dudt0: Array
    pressure: Array
    sound: Array
    invomega: Array
    zeta: Array
    hfactor: Array
    div_v: Array
    alpha: Array
    gpot: Array
    dt_part: Array          # per-particle timestep (block scheme)
    ueq: Array              # radws equilibrium energy (EnergyRadws)
    dt_therm: Array         # radws thermalisation timescale
    ionfrac: Array          # ionisation fraction (radiation schemes)
    # integer bookkeeping: shape (N,)
    ptype: Array
    flags: Array
    level: Array
    levelneib: Array
    nlast: Array
    tlast: Array
    iorig: Array
    # global scalars (0-d arrays so the whole state is one pytree)
    t: Array
    dt: Array
    nstep: Array            # integer step counter
    neib_overflow: Array    # bool: neighbour-capacity overflow this step
    # host-planned gravity-tree bucket gather map (G_pad, L), -1 = empty
    # (None when tree gravity is off; replanned every ntreebuildstep)
    bucket_map: Array = None
    # host-planned interaction lists for the listed (drift-skin) gravity
    # walk (ops.tree.plan_walk_lists); None when the frontier walk is used
    walk_mp: Array = None       # (G_pad, Wm) packed multipole cell ids
    walk_near: Array = None     # (G_pad, Wn) near-field leaf ids
    walk_plan_r: Array = None   # (N, ndim) unwrapped plan positions
    walk_anchors: Array = None  # (G_pad, ndim) bucket unwrap anchors
    walk_margin: Array = None   # () drift skin the lists stay valid within

    # -- helpers ------------------------------------------------------------
    @property
    def N(self) -> int:
        return self.r.shape[0]

    @property
    def ndim(self) -> int:
        return self.r.shape[1]

    @property
    def alive(self) -> Array:
        return (self.flags & FLAG_DEAD) == 0

    def replace(self, **kw) -> "SphState":
        return dataclasses.replace(self, **kw)


def make_sph_state(r: np.ndarray, v: np.ndarray, m: np.ndarray,
                   h: np.ndarray, u: np.ndarray,
                   dtype=jnp.float64) -> SphState:
    """Build an initial SphState from IC arrays (all velocities/energies at
    t=0; derived fields zeroed until the first density/force pass)."""
    N, ndim = r.shape
    if not jax.config.jax_enable_x64 and dtype == jnp.float64:
        dtype = jnp.float32
    fz = lambda: jnp.zeros((N,), dtype=dtype)
    iz = lambda: jnp.zeros((N,), dtype=jnp.int32)
    asdt = lambda x: jnp.asarray(x, dtype=dtype)
    return SphState(
        r=asdt(r), v=asdt(v), a=jnp.zeros((N, ndim), dtype=dtype),
        r0=asdt(r), v0=asdt(v), a0=jnp.zeros((N, ndim), dtype=dtype),
        m=asdt(m), h=asdt(h), rho=fz(),
        u=asdt(u), u0=asdt(u), dudt=fz(), dudt0=fz(),
        pressure=fz(), sound=fz(), invomega=jnp.ones((N,), dtype=dtype),
        zeta=fz(), hfactor=fz(), div_v=fz(),
        alpha=jnp.ones((N,), dtype=dtype), gpot=fz(), dt_part=fz(),
        ueq=asdt(u), dt_therm=jnp.full((N,), 1e30, dtype=dtype),
        ionfrac=fz(),
        ptype=iz() + GAS_TYPE, flags=iz(), level=iz(), levelneib=iz(),
        nlast=iz(), tlast=fz(), iorig=jnp.arange(N, dtype=jnp.int32),
        t=jnp.asarray(0.0, dtype=dtype), dt=jnp.asarray(0.0, dtype=dtype),
        nstep=jnp.asarray(0, dtype=jnp.int64 if
                          jax.config.jax_enable_x64 else jnp.int32),
        neib_overflow=jnp.asarray(False),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MfvState:
    """SoA meshless finite-volume particle state (reference
    MeshlessFVParticle, src/Headers/Particle.h:414-598)."""

    r: Array            # (N, ndim)
    v: Array
    a: Array            # gravitational/external acceleration
    r0: Array
    v0: Array
    a0: Array
    m: Array            # (N,)
    h: Array
    ndens: Array
    rho: Array
    u: Array
    pressure: Array
    sound: Array
    invomega: Array
    zeta: Array
    hfactor: Array
    vsig_max: Array
    gpot: Array
    Qcons0: Array       # (N, nvar)
    dQ: Array           # (N, nvar) accumulated flux increments
    B: Array            # (N, ndim, ndim)
    grad: Array         # (N, nvar, ndim)
    alpha_slope: Array  # (N, nvar)
    bad_grad: Array     # (N,) bool
    rdmdt: Array        # (N, ndim)
    ptype: Array
    flags: Array
    iorig: Array
    t: Array
    dt: Array
    nstep: Array
    neib_overflow: Array
    # block-timestep bookkeeping (reference MeshlessFVParticle carries the
    # same level/levelneib/nlast/tlast ints as SphParticle plus the flux
    # accumulators dQ/dQdt/rdmdt0, Particle.h:414-598)
    dQdt: Array = None      # (N, nvar) flux rate at own-step start
    rdmdt0: Array = None    # (N, ndim) committed rdmdt of previous step
    level: Array = None     # (N,) int32
    levelneib: Array = None
    nlast: Array = None
    tlast: Array = None
    bucket_map: Array = None    # (n_leaves, L) gravity-tree bucket plan
    # listed (drift-skin) gravity-walk plan, as on SphState
    walk_mp: Array = None
    walk_near: Array = None
    walk_plan_r: Array = None
    walk_anchors: Array = None
    walk_margin: Array = None

    @property
    def N(self) -> int:
        return self.r.shape[0]

    @property
    def ndim(self) -> int:
        return self.r.shape[1]

    @property
    def nvar(self) -> int:
        return self.ndim + 2

    @property
    def alive(self) -> Array:
        return (self.flags & FLAG_DEAD) == 0

    @property
    def Wprim(self) -> Array:
        """(N, nvar) primitive vector (v..., rho, pressure)."""
        return jnp.concatenate([self.v, self.rho[:, None],
                                self.pressure[:, None]], axis=-1)

    def replace(self, **kw) -> "MfvState":
        return dataclasses.replace(self, **kw)


def make_mfv_state(r: np.ndarray, v: np.ndarray, m: np.ndarray,
                   h: np.ndarray, u: np.ndarray,
                   dtype=jnp.float64) -> MfvState:
    N, ndim = r.shape
    nvar = ndim + 2
    if not jax.config.jax_enable_x64 and dtype == jnp.float64:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    fz = lambda: jnp.zeros((N,), dtype=dtype)
    iz = lambda: jnp.zeros((N,), dtype=jnp.int32)
    asdt = lambda x: jnp.asarray(x, dtype=dtype)
    return MfvState(
        r=asdt(r), v=asdt(v), a=jnp.zeros((N, ndim), dtype=dtype),
        r0=asdt(r), v0=asdt(v), a0=jnp.zeros((N, ndim), dtype=dtype),
        m=asdt(m), h=asdt(h), ndens=fz(), rho=fz(), u=asdt(u),
        pressure=fz(), sound=fz(), invomega=jnp.ones((N,), dtype=dtype),
        zeta=fz(), hfactor=fz(), vsig_max=fz(), gpot=fz(),
        Qcons0=jnp.zeros((N, nvar), dtype=dtype),
        dQ=jnp.zeros((N, nvar), dtype=dtype),
        B=jnp.zeros((N, ndim, ndim), dtype=dtype),
        grad=jnp.zeros((N, nvar, ndim), dtype=dtype),
        alpha_slope=jnp.ones((N, nvar), dtype=dtype),
        bad_grad=jnp.zeros((N,), dtype=bool),
        rdmdt=jnp.zeros((N, ndim), dtype=dtype),
        ptype=iz() + GAS_TYPE, flags=iz(),
        iorig=jnp.arange(N, dtype=jnp.int32),
        t=jnp.asarray(0.0, dtype=dtype), dt=jnp.asarray(0.0, dtype=dtype),
        nstep=jnp.asarray(0, dtype=jnp.int64 if
                          jax.config.jax_enable_x64 else jnp.int32),
        neib_overflow=jnp.asarray(False),
        dQdt=jnp.zeros((N, nvar), dtype=dtype),
        rdmdt0=jnp.zeros((N, ndim), dtype=dtype),
        level=iz(), levelneib=iz(), nlast=iz(), tlast=fz(),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NbodyState:
    """SoA star/N-body particle state (reference NbodyParticle,
    src/Headers/NbodyParticle.h:42: Hermite state a/adot/a2dot/a3dot plus
    step-start copies)."""

    r: Array
    v: Array
    a: Array
    adot: Array
    a2dot: Array
    a3dot: Array
    r0: Array
    v0: Array
    a0: Array
    adot0: Array
    a2dot0: Array     # step-start snap (Hermite6TS predictor/corrector)
    m: Array
    h: Array          # softening length
    gpot: Array
    dt_part: Array
    level: Array
    nlast: Array
    tlast: Array
    active: Array
    t: Array
    dt: Array
    nstep: Array

    @property
    def N(self) -> int:
        return self.r.shape[0]

    @property
    def ndim(self) -> int:
        return self.r.shape[1]

    def replace(self, **kw) -> "NbodyState":
        return dataclasses.replace(self, **kw)


def make_nbody_state(r: np.ndarray, v: np.ndarray, m: np.ndarray,
                     h: np.ndarray, dtype=jnp.float64) -> NbodyState:
    N, ndim = r.shape
    if not jax.config.jax_enable_x64 and dtype == jnp.float64:
        dtype = jnp.float32
    vz = lambda: jnp.zeros((N, ndim), dtype=dtype)
    fz = lambda: jnp.zeros((N,), dtype=dtype)
    iz = lambda: jnp.zeros((N,), dtype=jnp.int32)
    asdt = lambda x: jnp.asarray(x, dtype=dtype)
    return NbodyState(
        r=asdt(r), v=asdt(v), a=vz(), adot=vz(), a2dot=vz(), a3dot=vz(),
        r0=asdt(r), v0=asdt(v), a0=vz(), adot0=vz(), a2dot0=vz(),
        m=asdt(m), h=asdt(h), gpot=fz(), dt_part=fz(),
        level=iz(), nlast=iz(), tlast=fz(),
        active=jnp.ones((N,), dtype=bool),
        t=jnp.asarray(0.0, dtype=dtype), dt=jnp.asarray(0.0, dtype=dtype),
        nstep=jnp.asarray(0, dtype=jnp.int64 if
                          jax.config.jax_enable_x64 else jnp.int32),
    )


# ---------------------------------------------------------------------------
# Simulation domain & boundaries (reference src/Headers/DomainBox.h)
# ---------------------------------------------------------------------------

OPEN = 0
PERIODIC = 1
MIRROR = 2
WALL = 3

_BOUNDARY_CODES = {"open": OPEN, "periodic": PERIODIC, "mirror": MIRROR,
                   "wall": WALL}


@dataclasses.dataclass(frozen=True)
class DomainBox:
    """Static (compile-time) simulation box description."""

    ndim: int
    boxmin: Tuple[float, ...]
    boxmax: Tuple[float, ...]
    lhs: Tuple[int, ...]   # boundary type codes per dim
    rhs: Tuple[int, ...]

    @staticmethod
    def from_params(params) -> "DomainBox":
        ndim = params.intparams["ndim"]
        boxmin = tuple(params.floatparams[f"boxmin[{k}]"] for k in range(ndim))
        boxmax = tuple(params.floatparams[f"boxmax[{k}]"] for k in range(ndim))
        lhs = tuple(_BOUNDARY_CODES[params.stringparams[f"boundary_lhs[{k}]"]]
                    for k in range(ndim))
        rhs = tuple(_BOUNDARY_CODES[params.stringparams[f"boundary_rhs[{k}]"]]
                    for k in range(ndim))
        return DomainBox(ndim, boxmin, boxmax, lhs, rhs)

    @property
    def size(self) -> Tuple[float, ...]:
        return tuple(hi - lo for lo, hi in zip(self.boxmin, self.boxmax))

    def periodic_dims(self) -> Tuple[int, ...]:
        return tuple(k for k in range(self.ndim)
                     if self.lhs[k] == PERIODIC and self.rhs[k] == PERIODIC)

    def mirror_walls(self) -> Tuple[Tuple[int, int], ...]:
        """All (dim, side) mirror/wall boundaries; side 0=lhs, 1=rhs."""
        out = []
        for k in range(self.ndim):
            if self.lhs[k] in (MIRROR, WALL):
                out.append((k, 0))
            if self.rhs[k] in (MIRROR, WALL):
                out.append((k, 1))
        return tuple(out)

    def min_image(self, dr: Array) -> Array:
        """Apply the minimum-image convention along periodic dims
        (reference NearestPeriodicVector, src/Headers/GhostNeighbours.hpp)."""
        pdims = self.periodic_dims()
        if not pdims:
            return dr
        L = jnp.asarray(self.size, dtype=dr.dtype)
        mask = jnp.asarray([1.0 if k in pdims else 0.0
                            for k in range(self.ndim)], dtype=dr.dtype)
        return dr - mask * L * jnp.round(dr / L)

    def wrap(self, r: Array) -> Array:
        """Wrap positions into the box along periodic dims (the functional
        equivalent of SphIntegration::CheckBoundaries)."""
        pdims = self.periodic_dims()
        if not pdims:
            return r
        lo = jnp.asarray(self.boxmin, dtype=r.dtype)
        L = jnp.asarray(self.size, dtype=r.dtype)
        mask = jnp.asarray([k in pdims for k in range(self.ndim)])
        wrapped = lo + jnp.mod(r - lo, L)
        return jnp.where(mask, wrapped, r)

    def reflect(self, r: Array, v: Array) -> Tuple[Array, Array]:
        """Reflect escaped particles back across mirror/wall boundaries."""
        walls = self.mirror_walls()
        if not walls:
            return r, v
        for (k, side) in walls:
            bound = self.boxmin[k] if side == 0 else self.boxmax[k]
            crossed = (r[:, k] < bound) if side == 0 else (r[:, k] > bound)
            r = r.at[:, k].set(jnp.where(crossed, 2.0 * bound - r[:, k],
                                         r[:, k]))
            v = v.at[:, k].set(jnp.where(crossed, -v[:, k], v[:, k]))
        return r, v
