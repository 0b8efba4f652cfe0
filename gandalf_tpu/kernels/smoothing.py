"""SPH smoothing kernels (M4 cubic spline, Quintic spline, Gaussian).

Branchless `jnp.where` piecewise polynomials — every branch is evaluated
and selected elementwise, so the kernel fuses into the pair loops with no
table gather.  The reference's TabulatedKernel (src/Headers/SmoothingKernel.h:548-720)
is honoured with the same semantics but ZERO gathers: its floor-index lookup
`table[int(s*res/kernrange)]` with `table[i] = f(i*kernrange/res)` is exactly
`f(quantise(s))`, so `tabulated_kernel = 1` quantises the kernel argument to
the table grid and evaluates the same polynomials — bit-compatible with the
reference's table values at a cost of one floor+multiply instead of a gather.

Conventions match the reference kernels
(src/Hydrodynamics/{M4,Quintic,Gaussian}Kernel.cpp):

- ``s = r/h`` is the kernel argument; the kernel support ends at
  ``kernrange`` (M4: 2, Quintic: 3, Gaussian: truncated at 3).
- ``w0(s)``      : W(s) without the 1/h^ndim factor.
- ``w1(s)``      : dW/ds without the 1/h^(ndim+1) factor.
- ``womega(s)``  : h^(ndim+1) * dW/dh = -(ndim*w0 + s*w1)  (grad-h Omega sum).
- ``wzeta(s)``   : d(phi)/dh kernel (grad-h gravity zeta term).
- ``wgrav(s)``   : kernel-softened gravity force magnitude * s^2-normalised.
- ``wpot(s)``    : kernel-softened gravitational potential.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import jax.numpy as jnp

Array = jnp.ndarray


def _piecewise(s: Array, bounds, fns) -> Array:
    """Evaluate piecewise polynomials branchlessly.

    ``bounds`` is the increasing list of breakpoints ending the pieces;
    anything >= the final bound evaluates to 0 (handled by the caller passing
    a final fn if it should not).
    """
    out = jnp.zeros_like(s)
    lo = None
    for hi, fn in zip(bounds, fns):
        mask = s < hi if lo is None else (s >= lo) & (s < hi)
        out = jnp.where(mask, fn(s), out)
        lo = hi
    return out


@dataclasses.dataclass(frozen=True)
class SmoothingKernel:
    """A bundle of kernel functions for a given choice + dimensionality."""

    name: str
    ndim: int
    kernrange: float
    kernnorm: float
    kernnormdrag: float
    w0: Callable[[Array], Array]
    w1: Callable[[Array], Array]
    womega: Callable[[Array], Array]
    wzeta: Callable[[Array], Array]
    wgrav: Callable[[Array], Array]
    wpot: Callable[[Array], Array]

    @property
    def kernrangesqd(self) -> float:
        return self.kernrange * self.kernrange

    @property
    def invkernrange(self) -> float:
        return 1.0 / self.kernrange

    # squared-argument variants (reference SmoothingKernel.h:78-80); the
    # sqrt fuses into the pair loop, so these are simple wrappers.
    def w0_s2(self, ssqd: Array) -> Array:
        return self.w0(jnp.sqrt(ssqd))

    def womega_s2(self, ssqd: Array) -> Array:
        return self.womega(jnp.sqrt(ssqd))

    def wzeta_s2(self, ssqd: Array) -> Array:
        return self.wzeta(jnp.sqrt(ssqd))

    def wdrag(self, s: Array) -> Array:
        return self.kernnormdrag * s * s * self.w0(s)

    def wLOS(self, s: Array) -> Array:
        """Line-of-sight-integrated 3D kernel for column rendering
        (TabulatedKernel::initializeTableLOS + Render.cpp:229):
        wLOS(b) = 2 * int_0^sqrt(R^2-b^2) W3d(sqrt(z^2 + b^2)) dz,
        linearly interpolated on the same res-point impact-parameter grid
        the reference tabulates."""
        b, tab = _los_table(self.name)
        return jnp.interp(s, jnp.asarray(b), jnp.asarray(tab),
                          right=0.0)


# ---------------------------------------------------------------------------
# M4 cubic spline (kernrange = 2).  src/Hydrodynamics/M4Kernel.cpp:35-55 and
# src/Headers/SmoothingKernel.h:127-245.
# ---------------------------------------------------------------------------

def _m4(ndim: int) -> SmoothingKernel:
    norm = {1: 2.0 / 3.0, 2: 10.0 / (7.0 * math.pi), 3: 1.0 / math.pi}[ndim]
    normdrag = {1: 3.0, 2: 49.0 / 31.0, 3: 10.0 / 9.0}[ndim]
    nd = float(ndim)

    def w0(s):
        return _piecewise(
            s,
            (1.0, 2.0),
            (
                lambda s: norm * (1.0 - 1.5 * s * s + 0.75 * s * s * s),
                lambda s: 0.25 * norm * (2.0 - s) ** 3,
            ),
        )

    def w1(s):
        return _piecewise(
            s,
            (1.0, 2.0),
            (
                lambda s: norm * (-3.0 * s + 2.25 * s * s),
                lambda s: -0.75 * norm * (2.0 - s) ** 2,
            ),
        )

    def womega(s):
        return _piecewise(
            s,
            (1.0, 2.0),
            (
                lambda s: norm
                * (-nd + 1.5 * (nd + 2.0) * s * s - 0.75 * (nd + 3.0) * s**3),
                lambda s: norm
                * (
                    -2.0 * nd
                    + 3.0 * (nd + 1.0) * s
                    - 1.5 * (nd + 2.0) * s * s
                    + 0.25 * (nd + 3.0) * s**3
                ),
            ),
        )

    def wzeta(s):
        return _piecewise(
            s,
            (1.0, 2.0),
            (
                lambda s: 1.4 - 2.0 * s * s + 1.5 * s**4 - 0.6 * s**5,
                lambda s: 1.6
                - 4.0 * s * s
                + 4.0 * s**3
                - 1.5 * s**4
                + 0.2 * s**5,
            ),
        )

    def wgrav(s):
        # softened gravity force kernel; -> 1/s^2 outside support
        s_safe = jnp.maximum(s, 1e-30)
        return _piecewise(
            s,
            (1.0, 2.0, jnp.inf),
            (
                lambda s: (4.0 / 3.0) * s - 1.2 * s**3 + 0.5 * s**4,
                lambda s: (8.0 / 3.0) * s
                - 3.0 * s * s
                + 1.2 * s**3
                - (1.0 / 6.0) * s**4
                - (1.0 / 15.0) / (s_safe * s_safe),
                lambda s: 1.0 / (s_safe * s_safe),
            ),
        )

    def wpot(s):
        s_safe = jnp.maximum(s, 1e-30)
        return _piecewise(
            s,
            (1.0, 2.0, jnp.inf),
            (
                lambda s: 1.4 - (2.0 / 3.0) * s * s + 0.3 * s**4 - 0.1 * s**5,
                lambda s: -1.0 / (15.0 * s_safe)
                + 1.6
                - (4.0 / 3.0) * s * s
                + s**3
                - 0.3 * s**4
                + (1.0 / 30.0) * s**5,
                lambda s: 1.0 / s_safe,
            ),
        )

    return SmoothingKernel("m4", ndim, 2.0, norm, normdrag,
                           w0, w1, womega, wzeta, wgrav, wpot)


# ---------------------------------------------------------------------------
# Quintic spline (kernrange = 3).  src/Hydrodynamics/QuinticKernel.cpp and
# src/Headers/SmoothingKernel.h:283-420.
# ---------------------------------------------------------------------------

def _quintic(ndim: int) -> SmoothingKernel:
    norm = {1: 1.0 / 120.0, 2: 7.0 / (478.0 * math.pi),
            3: 1.0 / (120.0 * math.pi)}[ndim]
    normdrag = {1: 2.0, 2: 2868.0 / 2771.0, 3: 5.0 / 7.0}[ndim]
    nd = float(ndim)

    def w0(s):
        return _piecewise(
            s,
            (1.0, 2.0, 3.0),
            (
                lambda s: norm * (66.0 - 60.0 * s * s + 30.0 * s**4 - 10.0 * s**5),
                lambda s: norm
                * (51.0 + 75.0 * s - 210.0 * s * s + 150.0 * s**3
                   - 45.0 * s**4 + 5.0 * s**5),
                lambda s: norm * (3.0 - s) ** 5,
            ),
        )

    def w1(s):
        return _piecewise(
            s,
            (1.0, 2.0, 3.0),
            (
                lambda s: norm * (-120.0 * s + 120.0 * s**3 - 50.0 * s**4),
                lambda s: norm
                * (75.0 - 420.0 * s + 450.0 * s * s - 180.0 * s**3 + 25.0 * s**4),
                lambda s: norm
                * (-405.0 + 540.0 * s - 270.0 * s * s + 60.0 * s**3 - 5.0 * s**4),
            ),
        )

    def womega(s):
        return _piecewise(
            s,
            (1.0, 2.0, 3.0),
            (
                lambda s: norm
                * (-66.0 * nd + 60.0 * (nd + 2.0) * s * s
                   - 30.0 * (nd + 4.0) * s**4 + 10.0 * (nd + 5.0) * s**5),
                lambda s: norm
                * (-51.0 * nd - 75.0 * (nd + 1.0) * s
                   + 210.0 * (nd + 2.0) * s * s - 150.0 * (nd + 3.0) * s**3
                   + 45.0 * (nd + 4.0) * s**4 - 5.0 * (nd + 5.0) * s**5),
                lambda s: norm
                * (-243.0 * nd + 405.0 * (nd + 1.0) * s
                   - 270.0 * (nd + 2.0) * s * s + 90.0 * (nd + 3.0) * s**3
                   - 15.0 * (nd + 4.0) * s**4 + (nd + 5.0) * s**5),
            ),
        )

    def wzeta(s):
        return _piecewise(
            s,
            (1.0, 2.0, 3.0),
            (
                lambda s: 33.0 * s * s - 15.0 * s**4 + 5.0 * s**6
                - (10.0 / 7.0) * s**7 - 34.14285714,
                lambda s: 25.5 * s * s + 25.0 * s**3 - 52.5 * s**4
                + 30.0 * s**5 - 7.5 * s**6 + (5.0 / 7.0) * s**7
                - 33.785714286,
                lambda s: 121.5 * s * s - 135.0 * s**3 + 67.5 * s**4
                - 18.0 * s**5 + 2.5 * s**6 - (1.0 / 7.0) * s**7
                - 52.07142857,
            ),
        )

    c = 12.0 / 359.0

    def wgrav(s):
        s_safe = jnp.maximum(s, 1e-30)
        inv_s2 = 1.0 / (s_safe * s_safe)
        return _piecewise(
            s,
            (1.0, 2.0, 3.0, jnp.inf),
            (
                lambda s: c * (22.0 * s - 12.0 * s**3
                               + (30.0 / 7.0) * s**5 - 1.25 * s**6),
                lambda s: c * (17.0 * s + 18.75 * s * s - 42.0 * s**3
                               + 25.0 * s**4 - (45.0 / 7.0) * s**5
                               + 0.625 * s**6 + (5.0 / 56.0) * inv_s2),
                lambda s: c * (81.0 * s - 101.25 * s**2 + 54.0 * s**3
                               - 15.0 * s**4 + (15.0 / 7.0) * s**5
                               - 0.125 * s**6 - (507.0 / 56.0) * inv_s2),
                lambda s: inv_s2,
            ),
        )

    def wpot(s):
        s_safe = jnp.maximum(s, 1e-30)
        inv_s = 1.0 / s_safe
        return _piecewise(
            s,
            (1.0, 2.0, 3.0, jnp.inf),
            (
                lambda s: c * (-11.0 * s * s + 3.0 * s**4 - (5.0 / 7.0) * s**6
                               + (5.0 / 28.0) * s**7 + 478.0 / 14.0),
                lambda s: c * (-8.5 * s * s - 6.25 * s**3 + 10.5 * s**4
                               - 5.0 * s**5 + (15.0 / 14.0) * s**6
                               - (5.0 / 56.0) * s**7 + 473.0 / 14.0
                               + (5.0 / 56.0) * inv_s),
                lambda s: c * (-40.5 * s * s + 33.75 * s**3 - 13.5 * s**4
                               + 3.0 * s**5 - (5.0 / 14.0) * s**6
                               + (1.0 / 56.0) * s**7 + 729.0 / 14.0
                               - (507.0 / 56.0) * inv_s),
                lambda s: inv_s,
            ),
        )

    return SmoothingKernel("quintic", ndim, 3.0, norm, normdrag,
                           w0, w1, womega, wzeta, wgrav, wpot)


# ---------------------------------------------------------------------------
# Gaussian (truncated at s = 3).  src/Hydrodynamics/GaussianKernel.cpp and
# src/Headers/SmoothingKernel.h:440-548.  No gravity kernels (as reference).
# ---------------------------------------------------------------------------

def _gaussian(ndim: int) -> SmoothingKernel:
    norm = {1: 1.0 / math.sqrt(math.pi), 2: 1.0 / math.pi,
            3: 1.0 / math.pi ** 1.5}[ndim]
    normdrag = {1: 2.0, 2: 1.0, 3: 2.0 / 3.0}[ndim]
    nd = float(ndim)

    def w0(s):
        return jnp.where(s < 3.0, norm * jnp.exp(-s * s), 0.0)

    def w1(s):
        return jnp.where(s < 3.0, -2.0 * norm * s * jnp.exp(-s * s), 0.0)

    def womega(s):
        # h-derivative of the Gaussian: h^(ndim+1) dW/dh = norm (2s^2 - ndim) e^{-s^2}.
        # (The reference writes 2s instead of 2s^2 — SmoothingKernel.h:497 —
        # which is dimensionally inconsistent; we use the correct form.)
        return jnp.where(
            s < 3.0, norm * (2.0 * s * s - nd) * jnp.exp(-s * s), 0.0
        )

    def zero(s):
        return jnp.zeros_like(s)

    return SmoothingKernel("gaussian", ndim, 3.0, norm, normdrag,
                           w0, w1, womega, zero, zero, zero)


@dataclasses.dataclass(frozen=True)
class TabulatedKernel(SmoothingKernel):
    """Reference TabulatedKernel semantics (SmoothingKernel.h:548-720)
    without the memory table: every lookup quantises the argument to the
    table grid (floor index, `tableLookup`) and evaluates the base kernel's
    polynomial there — identical values, no gather.

    The gravity lookups return the EXACT far forms 1/s^2 (wgrav) and 1/s
    (wpot) for s >= kernrange, as GravTableLookup/GravPotTableLookup do;
    the squared-argument variants quantise on the s^2 grid
    (`initializeTableSqd` + `tableLookupSqd`)."""

    base: SmoothingKernel = None
    res: int = 1000

    def _q2(self, ssqd: Array) -> Array:
        step2 = self.kernrangesqd / self.res
        return jnp.sqrt(jnp.floor(ssqd / step2) * step2)

    def w0_s2(self, ssqd: Array) -> Array:
        return jnp.where(ssqd < self.kernrangesqd,
                         self.base.w0(self._q2(ssqd)), 0.0)

    def womega_s2(self, ssqd: Array) -> Array:
        return jnp.where(ssqd < self.kernrangesqd,
                         self.base.womega(self._q2(ssqd)), 0.0)

    def wzeta_s2(self, ssqd: Array) -> Array:
        return jnp.where(ssqd < self.kernrangesqd,
                         self.base.wzeta(self._q2(ssqd)), 0.0)

    def wdrag(self, s: Array) -> Array:
        step = self.kernrange / self.res
        sq = jnp.floor(s / step) * step
        return jnp.where(s < self.kernrange, self.base.wdrag(sq), 0.0)


def tabulated(base: SmoothingKernel, res: int = 1000) -> TabulatedKernel:
    """Wrap a kernel with the reference's table quantisation (res = the
    reference's TabulatedKernel resaux default, SmoothingKernel.h:666)."""
    rng = base.kernrange
    step = rng / res

    def q(s):
        return jnp.floor(s / step) * step

    def wrap(fn):
        return lambda s: jnp.where(s < rng, fn(q(s)), 0.0)

    def wrap_grav(fn, far):
        return lambda s: jnp.where(s < rng, fn(q(s)), far(s))

    inv2 = lambda s: 1.0 / jnp.maximum(s * s, 1e-60)
    inv1 = lambda s: 1.0 / jnp.maximum(s, 1e-30)
    return TabulatedKernel(
        name=base.name, ndim=base.ndim, kernrange=base.kernrange,
        kernnorm=base.kernnorm, kernnormdrag=base.kernnormdrag,
        w0=wrap(base.w0), w1=wrap(base.w1), womega=wrap(base.womega),
        wzeta=wrap(base.wzeta),
        wgrav=wrap_grav(base.wgrav, inv2),
        wpot=wrap_grav(base.wpot, inv1),
        base=base, res=res)


_FACTORIES = {"m4": _m4, "quintic": _quintic, "gaussian": _gaussian}


@functools.lru_cache(maxsize=None)
def _los_table(name: str, res: int = 1000):
    """LOS-integrated 3D kernel table (TabulatedKernel::initializeTableLOS,
    src/Hydrodynamics/TabulatedKernel.cpp:145-182): tableLOS[i] =
    2 * sum_j W3d(sqrt(z_j^2 + b^2)) dz over a 4000-step Riemann sum along
    half the chord at impact parameter b = i*kernrange/res."""
    import jax
    import numpy as np

    base = _FACTORIES[name](3)
    R = base.kernrange
    b = np.arange(res + 1) * (R / res)          # +1: interp endpoint at R
    dist = np.sqrt(np.maximum(R * R - b * b, 0.0))
    nsteps = 4000
    z = dist[:, None] / nsteps * np.arange(nsteps)[None, :]
    s = np.sqrt(z * z + (b * b)[:, None])
    # the first call may land inside a jit trace (wLOS in a rendering
    # kernel); the table is a constant — keep its construction eager
    with jax.ensure_compile_time_eval():
        w = np.asarray(base.w0(jnp.asarray(s)))
    table = 2.0 * w.sum(axis=1) * (dist / nsteps)
    return b, table


def kernel_factory(name: str, ndim: int,
                   tabulated_kernel: int = 0) -> SmoothingKernel:
    """Build a kernel by parameter-file name (reference kernel factory at
    src/GradhSph/GradhSphSimulation.cpp:56-177).  tabulated_kernel = 1
    applies the reference's table quantisation (see TabulatedKernel)."""
    if ndim not in (1, 2, 3):
        raise ValueError(f"ndim must be 1, 2 or 3, got {ndim}")
    key = name.lower()
    if key not in _FACTORIES:
        raise ValueError(f"Unrecognised kernel: {name!r}")
    kern = _FACTORIES[key](ndim)
    return tabulated(kern) if tabulated_kernel else kern
