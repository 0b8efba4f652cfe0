"""Grad-h SPH density / smoothing-length iteration.

Vectorisation of GradhSph::ComputeH
(src/GradhSph/GradhSph.cpp:142-326): the per-particle do-while becomes one
`lax.while_loop` over the whole batch with a converged mask, fixed-point
iteration for the first ITER_FP rounds and bisection afterwards — identical
update rules, evaluated for all particles simultaneously.

Sums are evaluated against an arbitrary "neighbour view": for the all-pairs
oracle the view is the full (mirrored/extended) particle set; the cell-list
path passes gathered (N, K) neighbour blocks with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..kernels.smoothing import SmoothingKernel
from ..state import DomainBox

Array = jnp.ndarray

ITER_FP = 30          # fixed-point iterations before bisection (GradhSph.cpp:228)
ITER_MAX = 150        # 5 * iteration_max (GradhSph.cpp:234)


class DensityResult(NamedTuple):
    h: Array
    rho: Array
    invomega: Array
    zeta: Array
    hfactor: Array      # 1/h^(ndim+1), as used in force kernels
    converged: Array


def _density_sums(kern: SmoothingKernel, ndim: int,
                  h: Array, m_i: Array,
                  drsqd: Array, m_j: Array,
                  mask: Optional[Array]):
    """rho / invomega / zeta sums at smoothing length h.

    drsqd: (N, K) squared distances to neighbour candidates,
    m_j:   (N, K) or (K,) neighbour masses,
    mask:  (N, K) validity (None = all valid).
    Mirrors the inner loop of GradhSph::ComputeH (GradhSph.cpp:184-210).
    """
    invh = 1.0 / h
    invhsqd = invh * invh
    ssqd = drsqd * invhsqd[:, None]
    w0 = kern.w0_s2(ssqd)
    womega = kern.womega_s2(ssqd)
    wzeta = kern.wzeta_s2(ssqd)
    if mask is not None:
        w0 = jnp.where(mask, w0, 0.0)
        womega = jnp.where(mask, womega, 0.0)
        wzeta = jnp.where(mask, wzeta, 0.0)
    mj = m_j if m_j.ndim == 2 else m_j[None, :]
    hfac = invh ** ndim
    rho = hfac * jnp.sum(mj * w0, axis=-1)
    invomega = hfac * invh * jnp.sum(mj * womega, axis=-1)
    zeta = invhsqd * jnp.sum(mj * wzeta, axis=-1)
    return rho, invomega, zeta


def compute_h(kern: SmoothingKernel, ndim: int,
              h_fac: float, h_converge: float,
              m: Array, h_init: Array,
              drsqd: Array, m_j: Array,
              mask: Optional[Array] = None,
              hmax: float = 1.0e30,
              h_lower_bound: float = 0.0,
              active: Optional[Array] = None) -> DensityResult:
    """Converge h and return density sums (batch ComputeH).

    Args:
      m:       (N,) particle masses.
      h_init:  (N,) starting guesses.
      drsqd:   (N, K) squared distances to neighbour candidates.
      m_j:     (K,) or (N, K) candidate masses.
      mask:    (N, K) candidate validity.
    """
    invndim = 1.0 / ndim

    def h_rho(rho):
        # h_fac*(m/rho)^(1/ndim)  (src/Headers/Sph.h:259)
        return h_fac * (m / jnp.maximum(rho, 1e-300)) ** invndim

    def body(carry):
        h, _, _, _, lo, hi, it, done = carry
        rho, invom, zeta, = _density_sums(kern, ndim, h, m, drsqd, m_j, mask)
        h_target = h_rho(rho)
        ok = (rho > 0.0) & (h > h_lower_bound)
        conv = ok & (jnp.abs(h - h_target) / h < h_converge)
        # Fixed point for the first ITER_FP rounds, then bisection
        # (GradhSph.cpp:227-242).
        too_big = (rho < 1e-30) | (h > h_target)
        start_bisect = it >= ITER_FP
        hi_n = jnp.where(start_bisect & too_big & ~conv, h, hi)
        lo_n = jnp.where(start_bisect & ~too_big & ~conv, h, lo)
        h_fp = h_target
        h_bis = 0.5 * (lo_n + hi_n)
        h_new = jnp.where(it < ITER_FP, h_fp, h_bis)
        h_out = jnp.where(conv | done, h, h_new)
        return (h_out, rho, invom, zeta, lo_n, hi_n, it + 1, done | conv)

    def cond(carry):
        *_, it, done = carry
        return (it < ITER_MAX) & ~jnp.all(done)

    N = m.shape[0]
    dtype = h_init.dtype
    lo0 = jnp.full((N,), h_lower_bound, dtype=dtype)
    hi0 = jnp.full((N,), hmax, dtype=dtype)
    # inactive lanes (padded slots) start "done" so they never spin the loop
    done0 = jnp.zeros((N,), dtype=bool) if active is None else ~active
    carry0 = (h_init, jnp.zeros_like(m), jnp.zeros_like(m),
              jnp.zeros_like(m), lo0, hi0, jnp.asarray(0), done0)
    # One priming evaluation so the carried sums always match the carried h.
    h, rho, invom, zeta, lo, hi, it, done = jax.lax.while_loop(
        cond, body, carry0)

    # Final normalisation (GradhSph.cpp:261-316): h from the last rho,
    # grad-h Omega and zeta corrections.
    h_final = jnp.maximum(h_rho(rho), h_lower_bound)
    invh = 1.0 / h_final
    hfactor = invh ** (ndim + 1)
    dh_drho = -invndim * h_final / jnp.maximum(rho, 1e-300)   # h_rho_deriv
    invomega = 1.0 / (1.0 - dh_drho * invom)
    zeta_final = dh_drho * zeta * invomega
    return DensityResult(h=h_final, rho=rho, invomega=invomega,
                         zeta=zeta_final, hfactor=hfactor, converged=done)


def compute_h_bruteforce(kern: SmoothingKernel, box: DomainBox,
                         h_fac: float, h_converge: float,
                         r: Array, m: Array, h_init: Array,
                         r_ext: Array, m_ext: Array,
                         hmax: float = 1.0e30,
                         active: Optional[Array] = None) -> DensityResult:
    """All-pairs oracle: density sums against the full extended particle set."""
    dr = box.min_image(r_ext[None, :, :] - r[:, None, :])
    drsqd = jnp.sum(dr * dr, axis=-1)
    return compute_h(kern, box.ndim, h_fac, h_converge,
                     m, h_init, drsqd, m_ext, mask=None, hmax=hmax,
                     active=active)
