"""Grad-h SPH self-gravity (all-pairs, kernel-softened, zeta-corrected).

Vectorisation of GradhSph::ComputeSphGravForces + ComputeDirectGravForces
(src/GradhSph/GradhSph.cpp:598-695).  Because wgrav(s) -> 1/s^2 and
w1(s) -> 0 beyond kernel support, the symmetric smoothed-pair formula
degenerates to the Newtonian direct sum automatically, so one all-pairs
evaluation covers both the "SPH neighbour" and "direct" branches of the
reference's tree walk.  G = 1 internal units.

The Barnes-Hut multipole far-field (ops.tree) replaces the direct sum at
scale; this module remains the small-N path and the tree's oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..kernels.smoothing import SmoothingKernel

Array = jnp.ndarray


class SphGravityResult(NamedTuple):
    a: Array        # (N, ndim) gravitational acceleration
    gpot: Array     # (N,) potential magnitude (positive, reference sign)


def star_gas_forces(kern: SmoothingKernel,
                    r_gas: Array, m_gas: Array, h_gas: Array,
                    r_star: Array, m_star: Array, h_star: Array,
                    star_active: Array):
    """Symmetric star<->gas kernel-softened gravity (mean-h softening;
    reference GradhSph::ComputeStarGravForces GradhSph.cpp:699 and
    HydroTree::UpdateAllStarGasForces Tree/HydroTree.cpp:552).

    Returns (a_gas (N,nd), gpot_gas (N,), a_star (Ns,nd), gpot_star (Ns,)).
    Inactive star slots contribute nothing and receive garbage (masked by
    the caller).  Zeta correction terms are omitted (TODO.md).
    """
    dr = r_star[None, :, :] - r_gas[:, None, :]      # (N, Ns, nd)
    drsqd = jnp.sum(dr * dr, axis=-1)
    # coincident pairs contribute zero force/potential slope (f32-safe:
    # no 0 * inf)
    zero = drsqd == 0.0
    drmag = jnp.sqrt(jnp.where(zero, 1.0, drsqd))
    inv_drmag = jnp.where(zero, 0.0, 1.0 / drmag)
    unit = dr * inv_drmag[..., None]
    hbar = 0.5 * (h_gas[:, None] + h_star[None, :])
    invh = 1.0 / hbar
    s = drmag * invh
    wg = kern.wgrav(s) * invh * invh
    wp = kern.wpot(s) * invh
    act = jnp.where(star_active[None, :], 1.0, 0.0)
    a_gas = jnp.sum((m_star[None, :] * wg * act)[..., None] * unit, axis=1)
    gpot_gas = jnp.sum(m_star[None, :] * wp * act, axis=1)
    a_star = -jnp.sum((m_gas[:, None] * wg)[..., None] * unit, axis=0)
    gpot_star = jnp.sum(m_gas[:, None] * wp, axis=0)
    return a_gas, gpot_gas, a_star, gpot_star


def direct_sph_gravity(kern: SmoothingKernel,
                       r: Array, m: Array, h: Array,
                       zeta: Array, hfactor: Array,
                       targets: Array = None) -> SphGravityResult:
    """Symmetric smoothed gravity over all pairs.

    paux = 0.5*[ wgrav(s_i)/h_i^2 + zeta_i*hfactor_i*w1(s_i)
               + wgrav(s_j)/h_j^2 + zeta_j*hfactor_j*w1(s_j) ]
    a_i += m_j * paux * dr_hat;  gpot_i += m_j * 0.5*(wpot_i/h_i + wpot_j/h_j)
    (GradhSph.cpp:598-640)

    `targets` (optional int indices) evaluates only those particles,
    still against every source; results are then (len(targets), ...).
    """
    N = r.shape[0]
    idx = jnp.arange(N) if targets is None else jnp.asarray(targets)
    dr = r[None, :, :] - r[idx][:, None, :]
    drsqd = jnp.sum(dr * dr, axis=-1)
    eye = idx[:, None] == jnp.arange(N)[None, :]
    drmag = jnp.sqrt(jnp.where(eye, 1.0, drsqd))
    inv_drmag = jnp.where(eye, 0.0, 1.0 / drmag)
    unit = dr * inv_drmag[..., None]

    zh = zeta * hfactor
    invh_i = (1.0 / h[idx])[:, None]
    invh_j = (1.0 / h)[None, :]
    s_i = drmag * invh_i
    s_j = drmag * invh_j
    paux = 0.5 * (
        invh_i * invh_i * kern.wgrav(s_i)
        + zh[idx][:, None] * kern.w1(s_i)
        + invh_j * invh_j * kern.wgrav(s_j)
        + zh[None, :] * kern.w1(s_j)
    )
    gaux = 0.5 * (invh_i * kern.wpot(s_i) + invh_j * kern.wpot(s_j))
    paux = jnp.where(eye, 0.0, paux)
    gaux = jnp.where(eye, 0.0, gaux)
    a = jnp.sum((m[None, :] * paux)[..., None] * unit, axis=1)
    gpot = jnp.sum(m[None, :] * gaux, axis=1)
    return SphGravityResult(a=a, gpot=gpot)
