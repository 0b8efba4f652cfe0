"""Gravity operators: direct summation (stars / small N) and SPH softened
pair gravity.

Direct summation suits N-body on an accelerator: the O(N^2) pairwise sums
are dense and regular (reference
Nbody::CalculateDirectGravForces, src/Nbody/Nbody.cpp:233-280, evaluates the
same sums with OpenMP loops).  G = 1 in internal units (reference SimUnits
convention).

Tree (Barnes-Hut multipole) gravity lives in gandalf_tpu.ops.tree.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from ..kernels.smoothing import SmoothingKernel

Array = jnp.ndarray


class GravityResult(NamedTuple):
    a: Array        # (N, ndim) gravitational acceleration
    adot: Array     # (N, ndim) jerk (zero when not requested)
    gpot: Array     # (N,) potential magnitude (positive, as reference)


def direct_nbody(r: Array, v: Array, m: Array,
                 compute_jerk: bool = True) -> GravityResult:
    """Unsoftened direct-sum gravity + jerk over all pairs.

    a_i    = sum_j m_j dr / |dr|^3
    adot_i = sum_j m_j [dv/|dr|^3 - 3 (dr.dv) dr / |dr|^5]
    gpot_i = sum_j m_j / |dr|      (positive magnitude, reference convention)
    """
    dr = r[None, :, :] - r[:, None, :]          # (N, N, ndim), j - i
    drsqd = jnp.sum(dr * dr, axis=-1)
    # mask self pairs AND coincident distinct pairs: collapsed sub-system
    # members (ops/systemtree internal integration) share one position and
    # must exert no mutual force in the global sum
    eye = jnp.eye(r.shape[0], dtype=bool) | (drsqd == 0.0)
    inv_dr = jnp.where(eye, 0.0, 1.0 / jnp.sqrt(jnp.where(eye, 1.0, drsqd)))
    inv_dr3 = inv_dr * inv_dr * inv_dr
    a = jnp.sum((m[None, :] * inv_dr3)[..., None] * dr, axis=1)
    gpot = jnp.sum(m[None, :] * inv_dr, axis=1)
    if compute_jerk:
        dv = v[None, :, :] - v[:, None, :]
        drdv = jnp.sum(dr * dv, axis=-1)
        adot = jnp.sum(
            (m[None, :] * inv_dr3)[..., None]
            * (dv - (3.0 * drdv * inv_dr * inv_dr)[..., None] * dr),
            axis=1)
    else:
        adot = jnp.zeros_like(a)
    return GravityResult(a=a, adot=adot, gpot=gpot)


def direct_snap(r: Array, v: Array, a: Array, m: Array) -> Array:
    """Direct-sum snap (2nd acceleration derivative) given current
    accelerations (the second force pass of NbodyHermite6TS,
    src/Nbody/NbodyHermite6TS.cpp CalculateDirectGravForces):

    with alpha = (dr.dv)/r^2, beta = (|dv|^2 + dr.da)/r^2 + alpha^2:
    snap_i = sum_j m_j [da/r^3 - 6 alpha jterm - 3 beta dr/r^3]
    where jterm = dv/r^3 - 3 alpha dr/r^3   (Nitadori & Makino 2008).
    """
    dr = r[None, :, :] - r[:, None, :]
    dv = v[None, :, :] - v[:, None, :]
    da = a[None, :, :] - a[:, None, :]
    drsqd = jnp.sum(dr * dr, axis=-1)
    eye = jnp.eye(r.shape[0], dtype=bool) | (drsqd == 0.0)
    inv_r2 = jnp.where(eye, 0.0, 1.0 / jnp.where(eye, 1.0, drsqd))
    inv_r = jnp.sqrt(inv_r2)
    inv_r3 = inv_r2 * inv_r
    alpha = jnp.sum(dr * dv, axis=-1) * inv_r2
    beta = (jnp.sum(dv * dv, axis=-1) + jnp.sum(dr * da, axis=-1)) \
        * inv_r2 + alpha * alpha
    jterm = dv * inv_r3[..., None] - (3.0 * alpha * inv_r3)[..., None] * dr
    snap = da * inv_r3[..., None] - (6.0 * alpha)[..., None] * jterm \
        - (3.0 * beta * inv_r3)[..., None] * dr
    return jnp.sum(m[None, :, None] * snap, axis=1)


def direct_softened(r: Array, v: Array, m: Array, h: Array,
                    kern: SmoothingKernel,
                    compute_jerk: bool = False) -> GravityResult:
    """Kernel-softened direct gravity with mean-h softening
    (reference grav_kernel = "mean_h"; Nbody.cpp softened variants):

    a_i = sum_j m_j wgrav(s) / hbar^2 * dr_hat,  s = |dr| / hbar,
    hbar = (h_i + h_j)/2; potential uses wpot(s)/hbar.
    """
    dr = r[None, :, :] - r[:, None, :]
    drsqd = jnp.sum(dr * dr, axis=-1)
    eye = jnp.eye(r.shape[0], dtype=bool) | (drsqd == 0.0)
    drmag = jnp.sqrt(jnp.where(eye, 1.0, drsqd))
    inv_drmag = jnp.where(eye, 0.0, 1.0 / drmag)
    hbar = 0.5 * (h[:, None] + h[None, :])
    invh = 1.0 / hbar
    s = drmag * invh
    wg = kern.wgrav(s) * invh * invh
    unit = dr * inv_drmag[..., None]
    a = jnp.sum((m[None, :] * wg * jnp.where(eye, 0.0, 1.0))[..., None]
                * unit, axis=1)
    gpot = jnp.sum(jnp.where(eye, 0.0, m[None, :] * kern.wpot(s) * invh),
                   axis=1)
    if compute_jerk:
        # softened jerk approximated with the Newtonian form outside the
        # kernel; adequate because softened systems use P(EC)^n iteration
        dv = v[None, :, :] - v[:, None, :]
        drdv = jnp.sum(dr * dv, axis=-1)
        inv_dr3 = inv_drmag ** 3
        adot = jnp.sum(
            (m[None, :] * inv_dr3)[..., None]
            * (dv - (3.0 * drdv * inv_drmag * inv_drmag)[..., None] * dr),
            axis=1)
    else:
        adot = jnp.zeros_like(a)
    return GravityResult(a=a, adot=adot, gpot=gpot)


def external_potential(name: str, cfg: dict, r: Array, v: Array):
    """External analytic potentials: returns (accel, jerk, potential)
    matching the reference's AddExternalPotential contributions
    (ExternalPotential.h:45-173; wired at Simulation.cpp:1163-1181 using
    floatparams mplummer/rplummer/avert — the `_extpot` parameter aliases
    exist in the reference's defaults table but are never read).

    `cfg` is a plain dict of the needed scalars (host-side constants baked
    into the jitted step): mplummer, rplummer, kgrav, avert, rzero.
    """
    z = jnp.zeros_like(r)
    zp = jnp.zeros(r.shape[:-1], dtype=r.dtype)
    if name in ("none", "silcc"):
        # reference SilccPotential::AddExternalPotential body is empty
        return z, z, zp
    if name == "plummer":
        mpl, rpl = cfg["mplummer"], cfg["rplummer"]
        rsqd = jnp.sum(r * r, axis=-1, keepdims=True)
        dvdr = jnp.sum(r * v, axis=-1, keepdims=True)
        denom = rsqd + rpl * rpl
        a = -mpl * r * denom ** -1.5
        adot = 3.0 * mpl * denom ** -2.5 * dvdr * r \
            - mpl * denom ** -1.5 * v
        pot = 2.0 * mpl * denom[..., 0] ** -0.5
        return a, adot, pot
    if name == "vertical":
        k, avert, rzero = cfg["kgrav"], cfg["avert"], cfg["rzero"]
        a = z.at[..., k].set(avert)
        pot = (r[..., k] - rzero) * avert
        return a, z, pot
    raise ValueError(f"Unrecognised external_potential: {name!r}")
