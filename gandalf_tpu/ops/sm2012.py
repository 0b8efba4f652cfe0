"""Saitoh & Makino (2012) density-independent SPH.

Vectorisation of SM2012Sph (src/SM2013/SM2012Sph.cpp): the
pressure force is built from the smoothed internal-energy density
q_i = (1/h^ndim) sum_j m_j u_j W(r_ij, h_i) instead of rho, which removes
the spurious surface tension at contact discontinuities:

  paux  = (gamma-1)/2 u_i u_j (1/q_i + 1/q_j) (w1_i hfac_i + w1_j hfac_j)
  a_i  += m_j paux r_hat
  dudt_i += (gamma-1)/2 u_i/q_i sum_j m_j u_j dvdr (w1_i hfac_i + w1_j hfac_j)

plus the standard mon97 artificial viscosity (SM2012Sph.cpp:293-415).
The h iteration is the plain h-rho fixed point (no grad-h Omega/zeta
corrections; SM2012Sph.cpp:133-240).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from ..kernels.smoothing import SmoothingKernel
from ..state import DomainBox
from .density import compute_h
from .forces import AVISC_MON97MM97, AVISC_NONE, ArtificialViscosity

Array = jnp.ndarray


class Sm2012Density(NamedTuple):
    h: Array
    rho: Array
    q: Array           # smoothed internal-energy density
    hfactor: Array     # 1/h^(ndim+1)


def sm2012_density(kern: SmoothingKernel, box: DomainBox,
                   h_fac: float, h_converge: float,
                   r: Array, m: Array, u: Array, h_init: Array,
                   r_ext: Array, m_ext: Array, u_ext: Array,
                   active: Optional[Array] = None) -> Sm2012Density:
    """h-rho iteration + the q sum at the converged h
    (SM2012Sph::ComputeH, SM2012Sph.cpp:133-240)."""
    ndim = box.ndim
    dr = box.min_image(r_ext[None, :, :] - r[:, None, :])
    drsqd = jnp.sum(dr * dr, axis=-1)
    dens = compute_h(kern, ndim, h_fac, h_converge, m, h_init,
                     drsqd, m_ext, mask=None, active=active)
    invh = 1.0 / dens.h
    ssqd = drsqd * (invh * invh)[:, None]
    w0 = kern.w0_s2(ssqd)
    q = (invh ** ndim) * jnp.sum((m_ext * u_ext)[None, :] * w0, axis=-1)
    return Sm2012Density(h=dens.h, rho=dens.rho, q=q,
                         hfactor=invh ** (ndim + 1))


class Sm2012Forces(NamedTuple):
    a: Array
    dudt: Array
    div_v: Array


def sm2012_forces(kern: SmoothingKernel, visc: ArtificialViscosity,
                  gamma: float, box: DomainBox,
                  r: Array, v: Array, m: Array, u: Array,
                  h: Array, rho: Array, q: Array, hfactor: Array,
                  sound: Array, alpha: Array,
                  r_ext: Array, v_ext: Array, m_ext: Array, u_ext: Array,
                  h_ext: Array, rho_ext: Array, q_ext: Array,
                  hfactor_ext: Array, sound_ext: Array, alpha_ext: Array
                  ) -> Sm2012Forces:
    """All-pairs SM2012 hydro force (SM2012Sph::ComputeSphHydroForces)."""
    dr = box.min_image(r_ext[None, :, :] - r[:, None, :])
    drsqd = jnp.sum(dr * dr, axis=-1)
    valid = drsqd > 0.0
    drmag = jnp.sqrt(jnp.where(valid, drsqd, 1.0))
    unit = jnp.where(valid[..., None], dr / drmag[..., None], 0.0)

    invh_i = (1.0 / h)[:, None]
    invh_j = (1.0 / h_ext)[None, :]
    wkerni = hfactor[:, None] * kern.w1(drmag * invh_i)
    wkernj = hfactor_ext[None, :] * kern.w1(drmag * invh_j)
    wkerni = jnp.where(valid, wkerni, 0.0)
    wkernj = jnp.where(valid, wkernj, 0.0)

    dv = v_ext[None, :, :] - v[:, None, :]
    dvdr = jnp.sum(dv * unit, axis=-1)
    div_v = -jnp.sum(m_ext[None, :] * dvdr * wkerni, axis=-1) \
        / jnp.maximum(rho, 1e-30)

    invq_i = (1.0 / jnp.maximum(q, 1e-30))[:, None]
    invq_j = 1.0 / jnp.maximum(q_ext, 1e-30)[None, :]
    paux = 0.5 * (gamma - 1.0) * u[:, None] * u_ext[None, :] \
        * (invq_i + invq_j) * (wkerni + wkernj)

    # adiabatic compression term (SM2012Sph.cpp:400-410):
    # dudt_i += (gamma-1)/2 u_i/q_i m_j u_j dvdr (wk_i + wk_j)
    dudt = 0.5 * (gamma - 1.0) * u * (1.0 / jnp.maximum(q, 1e-30)) \
        * jnp.sum(m_ext[None, :] * u_ext[None, :] * dvdr
                  * (wkerni + wkernj), axis=-1)

    if visc.avisc != AVISC_NONE:
        invrho_i = (1.0 / jnp.maximum(rho, 1e-30))[:, None]
        invrho_j = 1.0 / jnp.maximum(rho_ext, 1e-30)[None, :]
        winvrho = 0.25 * (wkerni + wkernj) * (invrho_i + invrho_j)
        if visc.avisc == AVISC_MON97MM97:
            alpha_eff = 0.5 * (alpha[:, None] + alpha_ext[None, :])
        else:
            alpha_eff = visc.alpha_visc
        vsignal = (sound[:, None] + sound_ext[None, :]
                   - visc.beta_visc * alpha_eff * dvdr)
        approach = valid & (dvdr < 0.0)
        paux = paux - jnp.where(
            approach, alpha_eff * vsignal * dvdr * winvrho, 0.0)
        dudt = dudt - jnp.sum(
            jnp.where(approach, 0.5 * m_ext[None, :] * alpha_eff
                      * vsignal * dvdr * dvdr * winvrho, 0.0), axis=-1)

    a = jnp.sum((m_ext[None, :] * paux)[..., None] * unit, axis=-2)
    return Sm2012Forces(a=a, dudt=dudt, div_v=div_v)


def sm2012_forces_view(kern: SmoothingKernel, visc: ArtificialViscosity,
                       gamma: float,
                       v: Array, u: Array, h: Array, rho: Array,
                       q: Array, hfactor: Array, sound: Array,
                       alpha: Array, dr: Array, nb: dict,
                       mask: Optional[Array]) -> Sm2012Forces:
    """SM2012 hydro force over a per-row neighbour VIEW (N, K): dr is
    r_j - r_i, nb carries v/m/u/h/rho/q/hfactor/sound/alpha arrays of
    shape (N, K)(, ndim).  Shared by the all-pairs oracle and the
    structured-grid gather path (SM2012Sph::ComputeSphHydroForces)."""
    drsqd = jnp.sum(dr * dr, axis=-1)
    valid = drsqd > 0.0
    if mask is not None:
        valid = valid & mask
    drmag = jnp.sqrt(jnp.where(valid, drsqd, 1.0))
    unit = jnp.where(valid[..., None], dr / drmag[..., None], 0.0)

    invh_i = (1.0 / h)[:, None]
    h_j = jnp.where(valid, nb["h"], 1.0)
    wkerni = hfactor[:, None] * kern.w1(drmag * invh_i)
    wkernj = nb["hfactor"] * kern.w1(drmag / h_j)
    wkerni = jnp.where(valid, wkerni, 0.0)
    wkernj = jnp.where(valid, wkernj, 0.0)

    dv = nb["v"] - v[:, None, :]
    dvdr = jnp.sum(dv * unit, axis=-1)
    m_j = jnp.where(valid, nb["m"], 0.0)
    div_v = -jnp.sum(m_j * dvdr * wkerni, axis=-1) \
        / jnp.maximum(rho, 1e-30)

    invq_i = (1.0 / jnp.maximum(q, 1e-30))[:, None]
    invq_j = 1.0 / jnp.maximum(nb["q"], 1e-30)
    u_j = jnp.where(valid, nb["u"], 0.0)
    paux = 0.5 * (gamma - 1.0) * u[:, None] * u_j \
        * (invq_i + invq_j) * (wkerni + wkernj)

    dudt = 0.5 * (gamma - 1.0) * u * (1.0 / jnp.maximum(q, 1e-30)) \
        * jnp.sum(m_j * u_j * dvdr * (wkerni + wkernj), axis=-1)

    if visc.avisc != AVISC_NONE:
        invrho_i = (1.0 / jnp.maximum(rho, 1e-30))[:, None]
        invrho_j = 1.0 / jnp.maximum(nb["rho"], 1e-30)
        winvrho = 0.25 * (wkerni + wkernj) * (invrho_i + invrho_j)
        if visc.avisc == AVISC_MON97MM97:
            alpha_eff = 0.5 * (alpha[:, None] + nb["alpha"])
        else:
            alpha_eff = visc.alpha_visc
        vsignal = (sound[:, None] + nb["sound"]
                   - visc.beta_visc * alpha_eff * dvdr)
        approach = valid & (dvdr < 0.0)
        paux = paux - jnp.where(
            approach, alpha_eff * vsignal * dvdr * winvrho, 0.0)
        dudt = dudt - jnp.sum(
            jnp.where(approach, 0.5 * m_j * alpha_eff
                      * vsignal * dvdr * dvdr * winvrho, 0.0), axis=-1)

    a = jnp.sum((m_j * paux)[..., None] * unit, axis=-2)
    return Sm2012Forces(a=a, dudt=dudt, div_v=div_v)


def sm2012_hydro_pass_grid(kern: SmoothingKernel,
                           visc: ArtificialViscosity, gamma: float,
                           spec, h_fac: float, h_converge: float,
                           s, alive: Array, hydro_forces: bool):
    """Structured-grid SM2012 hydro pass: grid27 candidate gathers +
    the shared view kernels (the SM2012SphTree analogue; round-2 left
    SM2012 on the O(N^2) fallback).  Returns the updated SphState."""
    from . import sph_grid27 as g
    from .active_grid import gather_active_candidates

    nd = s.ndim
    b = g.bin_particles(spec, s.r, discard=~alive)
    hmax = g.hmax_of(spec, kern.kernrange)
    idx = jnp.arange(s.N, dtype=jnp.int32)
    ag = gather_active_candidates(spec, b, s.r, idx, alive)
    cid = jnp.maximum(ag.ids, 0)
    drsqd = jnp.sum(ag.dr * ag.dr, axis=-1)
    m_j = jnp.where(ag.mask, s.m[cid], 0.0)
    u_j = jnp.where(ag.mask, s.u[cid], 0.0)

    dens = compute_h(kern, nd, h_fac, h_converge, s.m, s.h, drsqd, m_j,
                     mask=ag.mask, hmax=hmax)
    invh = 1.0 / dens.h
    ssqd = drsqd * (invh * invh)[:, None]
    w0 = jnp.where(ag.mask, kern.w0_s2(ssqd), 0.0)
    q = (invh ** nd) * jnp.sum(m_j * u_j * w0, axis=-1)

    pressure = (gamma - 1.0) * jnp.maximum(dens.rho, 1e-30) * s.u
    sound = jnp.sqrt(gamma * (gamma - 1.0) * jnp.maximum(s.u, 1e-30))
    sane = lambda x, d: jnp.where(alive, x, d)
    s = s.replace(h=sane(dens.h, 1.0), rho=sane(dens.rho, 1.0),
                  pressure=sane(pressure, 0.0), sound=sane(sound, 0.0),
                  hfactor=sane(invh ** (nd + 1), 0.0),
                  invomega=jnp.ones_like(s.invomega),
                  zeta=jnp.zeros_like(s.zeta))
    overflow = b.overflow | jnp.any(
        jnp.where(alive, ~dens.converged, False)) | jnp.any(
        jnp.where(alive, dens.h, 0.0) > 0.99 * hmax)
    if not hydro_forces:
        return s.replace(a=jnp.zeros_like(s.a),
                         dudt=jnp.zeros_like(s.dudt),
                         div_v=jnp.zeros_like(s.div_v),
                         neib_overflow=s.neib_overflow | overflow), q

    q_safe = jnp.where(alive, q, 1.0)
    nb = {
        "v": jnp.where(ag.mask[..., None], s.v[cid], 0.0),
        "m": m_j, "u": u_j,
        "h": jnp.where(ag.mask, s.h[cid], 1.0),
        "rho": jnp.where(ag.mask, s.rho[cid], 1.0),
        "q": jnp.where(ag.mask, q_safe[cid], 1.0),
        "hfactor": jnp.where(ag.mask, s.hfactor[cid], 0.0),
        "sound": jnp.where(ag.mask, s.sound[cid], 0.0),
        "alpha": jnp.where(ag.mask, s.alpha[cid], 0.0),
    }
    f = sm2012_forces_view(kern, visc, gamma, s.v, s.u, s.h, s.rho,
                           q_safe, s.hfactor, s.sound, s.alpha,
                           ag.dr, nb, ag.mask)
    return s.replace(a=jnp.where(alive[:, None], f.a, 0.0),
                     dudt=sane(f.dudt, 0.0),
                     div_v=sane(f.div_v, 0.0),
                     neib_overflow=s.neib_overflow | overflow), q


# ---------------------------------------------------------------------------
# Dense 27-shift grid pass (shard_map-compatible: fields travel as ghosted
# cell tensors, so ppermute halos provide remote neighbours — the
# gather-by-id pass above cannot see across shards)
# ---------------------------------------------------------------------------

def sm2012_pass_dense(kern: SmoothingKernel, visc: ArtificialViscosity,
                      gamma: float, spec, h_fac: float, h_converge: float,
                      binning, s, alive, hydro_forces: bool,
                      ghost_fn=None, count_alive=None, n_real=None):
    """SM2012 hydro pass over DENSE shifted cell tensors: h-rho iteration
    via density_grid27, then the q sum and the view force kernel
    accumulated over the (2qz+1)*3^(nd-1) shifts.  `binning` is the
    particle binning for `spec` (local slab inside shard_map).  Returns
    the updated SphState.

    `count_alive` (optional) restricts the overflow check to a subset of
    rows — the mirror path passes the parent rows only, because image
    copies at the edge of the image band legitimately miss their own
    second-layer neighbours and run h past hmax (their h result is
    discarded).

    `n_real` (optional, mirror path) is the PARENT particle count of a
    mirror-extended state (row layout [parents, wall-1 images, ...], so
    parent(row) = row % n_real).  Image rows then take their parent's
    freshly computed h/rho (and q below) as NEIGHBOUR values — by mirror
    symmetry the image's true field equals its parent's, while its own
    band-truncated recomputation is wrong near the band edge (the same
    parent re-scatter the grad-h mirror grid pass does,
    sph_grid27._hydro_pass_grid27_mirror)."""
    import dataclasses as _dc

    from . import sph_grid27 as g

    nd = s.ndim
    ghost = ghost_fn or g.add_ghost_layers
    d = lambda x: g.to_dense(spec, binning, x)
    back = lambda x: g.from_dense(spec, binning, x)
    fill = g.dense_fill_mask(spec, binning) & d(alive)
    hmax = g.hmax_of(spec, kern.kernrange)

    r_d, m_d, h_d = d(s.r), d(s.m), d(s.h)
    cf = None if count_alive is None else d(count_alive)
    dens = g.density_grid27(kern, spec, h_fac, h_converge,
                            r_d, m_d, h_d, fill, hmax, ghost_fn=ghost,
                            count_fill=cf)
    par = None
    if n_real is not None and s.N != n_real:
        par = jnp.arange(s.N, dtype=jnp.int32) % n_real
        sync = lambda x_d: d(back(x_d)[par])
        dens = dens._replace(h=sync(dens.h), rho=sync(dens.rho))

    # dense q sum + forces over the shift stencil, accumulated through
    # the shared view kernel (flattened (cells*K, K_nb) views per shift)
    K = spec.k_cell
    shifts = g._shifts(nd, spec.qz)
    pressure = (gamma - 1.0) * jnp.maximum(dens.rho, 1e-30) * d(s.u)
    sound = jnp.sqrt(gamma * (gamma - 1.0) * jnp.maximum(d(s.u), 1e-30))
    invh = 1.0 / jnp.maximum(dens.h, 1e-30)
    hfactor = invh ** (nd + 1)

    # packed neighbour tensor: [m, u, h, rho, hfactor, sound, alpha]
    pk = jnp.stack([m_d, d(s.u), dens.h, dens.rho, hfactor, sound,
                    d(s.alpha)], axis=-1)
    rp = ghost(spec, r_d, shift_vec=True)
    vp = ghost(spec, d(s.v))
    pkp = ghost(spec, pk)
    fp_ = ghost(spec, fill)

    flat = lambda x: x.reshape((-1,) + x.shape[nd + 1:])
    h_f = flat(jnp.maximum(dens.h, 1e-30))
    u_f = flat(d(s.u))
    rho_f = flat(dens.rho)
    hfac_f = flat(hfactor)
    snd_f = flat(sound)
    al_f = flat(d(s.alpha))
    v_f = flat(d(s.v))
    r_f = flat(r_d)
    Np = r_f.shape[0]

    # pass 1: q sum
    q = jnp.zeros((Np,), r_f.dtype)
    for sh in shifts:
        r_nb = g._shift_view(spec, rp, sh)
        pk_nb = g._shift_view(spec, pkp, sh)
        f_nb = g._shift_view(spec, fp_, sh)
        dr = r_nb[..., None, :, :] - r_d[..., :, None, :]
        drsqd = jnp.sum(dr * dr, axis=-1).reshape(-1, K)
        mu_nb = (pk_nb[..., 0] * pk_nb[..., 1])[..., None, :]
        mu_f = jnp.broadcast_to(mu_nb, dr.shape[:-1]).reshape(-1, K)
        ok = jnp.broadcast_to(f_nb[..., None, :],
                              dr.shape[:-1]).reshape(-1, K)
        ssqd = drsqd * (1.0 / h_f ** 2)[:, None]
        q = q + jnp.sum(jnp.where(ok, mu_f * kern.w0_s2(ssqd), 0.0), -1)
    q = q * (1.0 / h_f) ** nd
    if par is not None:
        # image rows take the parent's q (mirror symmetry; see n_real)
        q = flat(d(back(q.reshape(spec.ncells + (K,)))[par]))
    q_safe = jnp.maximum(q, 1e-30)

    a = jnp.zeros((Np, nd), r_f.dtype)
    dudt = jnp.zeros((Np,), r_f.dtype)
    div_v = jnp.zeros((Np,), r_f.dtype)
    if hydro_forces:
        qp = ghost(spec, q.reshape(spec.ncells + (K,)))
        for sh in shifts:
            r_nb = g._shift_view(spec, rp, sh)
            v_nb = g._shift_view(spec, vp, sh)
            pk_nb = g._shift_view(spec, pkp, sh)
            q_nb = g._shift_view(spec, qp, sh)
            f_nb = g._shift_view(spec, fp_, sh)
            dr = (r_nb[..., None, :, :]
                  - r_d[..., :, None, :]).reshape(-1, K, nd)
            bshape = (Np, K)
            bc = lambda x: jnp.broadcast_to(
                x[..., None, :], x.shape[:nd] + (K,)
                + x.shape[nd:]).reshape(bshape + x.shape[nd + 1:])
            nb = {
                "v": jnp.broadcast_to(
                    v_nb[..., None, :, :],
                    v_nb.shape[:nd] + (K, K, nd)).reshape(Np, K, nd),
                "m": bc(pk_nb[..., 0]), "u": bc(pk_nb[..., 1]),
                "h": jnp.maximum(bc(pk_nb[..., 2]), 1e-30),
                "rho": bc(pk_nb[..., 3]), "hfactor": bc(pk_nb[..., 4]),
                "sound": bc(pk_nb[..., 5]), "alpha": bc(pk_nb[..., 6]),
                "q": jnp.maximum(bc(q_nb), 1e-30),
            }
            mask = bc(f_nb)
            f = sm2012_forces_view(kern, visc, gamma, v_f, u_f, h_f,
                                   rho_f, q_safe, hfac_f, snd_f, al_f,
                                   dr, nb, mask)
            a = a + f.a
            dudt = dudt + f.dudt
            div_v = div_v + f.div_v

    shp = spec.ncells + (K,)
    sane = lambda x, v0: jnp.where(alive, back(x.reshape(shp)), v0)
    sanev = lambda x, v0: jnp.where(alive[:, None],
                                    back(x.reshape(shp + (nd,))), v0)
    press_p = jnp.where(alive, back(pressure), 0.0)
    sound_p = jnp.where(alive, back(sound), 0.0)
    out = s.replace(
        h=jnp.where(alive, back(dens.h), 1.0),
        rho=jnp.where(alive, back(dens.rho), 1.0),
        pressure=press_p, sound=sound_p,
        hfactor=jnp.where(alive, back(hfactor), 0.0),
        invomega=jnp.ones_like(s.invomega),
        zeta=jnp.zeros_like(s.zeta),
        a=sanev(a, jnp.zeros_like(s.a)),
        dudt=sane(dudt, 0.0), div_v=sane(div_v, 0.0),
        neib_overflow=s.neib_overflow | dens.overflow | binning.overflow)
    return out
