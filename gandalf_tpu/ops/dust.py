"""Dust dynamics: semi-implicit gas-dust drag (Loren-Aguilar & Bate 2014).

Vectorisation of DustSemiImplictForces::ComputeDragForces and the
test-particle interpolant (src/Common/Dust.cpp:812-1145) plus the stopping-
time laws (src/Headers/DragLaws.h:27-108).

The reference walks gas<->dust neighbour lists; here one dense (N, N) pass
evaluates every cross-type pair with the pairwise, angular-momentum-
conserving projection along the separation vector.  The scheme integrates
the linear drag exactly over the step (unconditionally stable):

  Xi     = (1 - e^-tau) / (dt rho),   tau = dt / t_s,  rho = rho_g + rho_d
  Lambda = (dt + t_s) Xi - 1/rho
  S      = (dv.r + dt da.r) Xi - (da.r) Lambda
  a_i   -= ndim rho_j S r_hat wdrag(q) m_j / (rho_j h_gas^ndim)

Gas particles convert the lost kinetic energy into heat; dust deposits its
share onto its gas neighbours (energy conserving).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax.numpy as jnp
from numpy import prod as np_prod

from ..kernels.smoothing import SmoothingKernel
from ..state import DUST_TYPE, GAS_TYPE, DomainBox

Array = jnp.ndarray

EPSTEIN_NORM = 0.4699928014933126      # 3 sqrt(pi/8)/4 (DragLaws.h:73)


@dataclasses.dataclass(frozen=True)
class DragLaw:
    """Stopping-time prescription (DragLaws.h)."""

    law: str = "fixed"                 # fixed | density | epstein | lp12
    coeff: float = 1.0
    use_energy_term: bool = True

    @staticmethod
    def from_params(params) -> "DragLaw":
        return DragLaw(law=params.stringparams["drag_law"],
                       coeff=params.floatparams["drag_coeff"],
                       use_energy_term=params.stringparams["gas_eos"]
                       != "isothermal")

    def t_stop(self, grho: Array, drho: Array, gsound: Array) -> Array:
        K = self.coeff
        if self.law == "fixed":
            return jnp.full_like(grho, 1.0 / K)
        if self.law == "density":
            return 1.0 / ((grho + drho) * K)
        if self.law == "epstein":
            return EPSTEIN_NORM / ((grho + drho) * gsound * K)
        if self.law in ("lp12", "LP12"):
            return drho * grho / ((grho + drho) * K)
        raise ValueError(f"unknown drag_law {self.law!r}")


class DragResult(NamedTuple):
    a_drag: Array      # (N, ndim)
    dudt: Array        # (N,) drag heating for gas particles
    sound: Array       # (N,) dust timestep sound speed (max gas neighbour)
    div_v: Array       # (N,) dust |dv|/h for the timestep criterion


def drag_twofluid(kern: SmoothingKernel, law: DragLaw, box: DomainBox,
                  dt: Array,
                  r: Array, v: Array, a: Array, a0: Array,
                  m: Array, h: Array,
                  rho: Array, sound: Array, ptype: Array,
                  alive: Optional[Array] = None,
                  test_particle: bool = False) -> DragResult:
    """Dense all-pairs semi-implicit drag between gas and dust
    (DustSemiImplictForces::ComputeDragForces, Dust.cpp:1004-1135).

    All inputs at the force-evaluation point of the step; `a` is the
    non-drag (hydro + gravity) acceleration, `a0` the start-of-step
    acceleration (the kick-start velocity is v - dt/2 a0,
    Dust.cpp:41-55); dt = 0 yields the instantaneous drag force (used
    at bootstrap).  `dt` may be a scalar or per-particle (N,) — the
    reference passes the ACTIVE particle's own drag_timestep
    (Dust.cpp:216-218,561) and uses it on both sides of the pair
    (get_velocity_difference, Dust.cpp:52-55)."""
    N, ndim = r.shape
    dt = jnp.broadcast_to(jnp.asarray(dt, r.dtype), (N,))[:, None]
    is_gas = ptype == GAS_TYPE
    is_dust = ptype == DUST_TYPE
    if alive is not None:
        is_gas = is_gas & alive
        is_dust = is_dust & alive

    dr = box.min_image(r[:, None, :] - r[None, :, :])        # r_i - r_j
    drsqd = jnp.sum(dr * dr, axis=-1)
    pair = (is_gas[:, None] & is_dust[None, :]) \
        | (is_dust[:, None] & is_gas[None, :])
    pair = pair & (drsqd > 0.0)
    drmag = jnp.sqrt(jnp.where(drsqd > 0, drsqd, 1.0))
    unit = dr / drmag[..., None]

    # drag kernel evaluated with the GAS side's smoothing length
    # (Dust.cpp:1046-1050)
    h_gas = jnp.where(is_gas[:, None], h[:, None], h[None, :])
    invh = 1.0 / h_gas
    wraw = (invh ** ndim) * kern.wdrag(drmag * invh)
    wraw = jnp.where(pair, wraw, 0.0)
    wkern = wraw * m[None, :] / jnp.maximum(rho[None, :], 1e-30)

    # velocity difference at the start of the kick, with the TARGET
    # row's dt on both sides (get_velocity_difference, Dust.cpp:52-55)
    da0 = a0[:, None, :] - a0[None, :, :]
    dv = v[:, None, :] - v[None, :, :] - 0.5 * dt[..., None] * da0
    da = a[:, None, :] - a[None, :, :]
    dvdr = jnp.sum(dv * unit, axis=-1)
    dadr = jnp.sum(da * unit, axis=-1)

    grho = jnp.where(is_gas[:, None], rho[:, None], rho[None, :])
    drho = jnp.where(is_gas[:, None], rho[None, :], rho[:, None])
    gsound = jnp.where(is_gas[:, None], sound[:, None], sound[None, :])
    if test_particle:
        # dust feels the gas but not vice versa (DustTestParticle,
        # Dust.cpp:357-381; t_stop called with drho = 0, :963)
        drho = jnp.zeros_like(drho)
    t_s = jnp.maximum(law.t_stop(grho, drho, gsound), 1e-30)

    rho_t = grho + drho
    tau = dt / t_s
    # exact integral vs series for small tau (Dust.cpp:1084-1093)
    dt_safe = jnp.maximum(dt, 1e-30)
    xi_big = (1.0 - jnp.exp(-tau)) / (dt_safe * rho_t)
    lam_big = (dt + t_s) * xi_big - 1.0 / rho_t
    xi_small0 = (1.0 - 0.5 * tau * (1.0 - tau / 3.0)) / rho_t
    lam_small = (1.0 + tau) * xi_small0 - 1.0 / rho_t
    xi_small = xi_small0 / t_s
    big = tau > 1e-3
    Xi = jnp.where(big, xi_big, xi_small)
    Lam = jnp.where(big, lam_big, lam_small)

    S = (dvdr + dt * dadr) * Xi - dadr * Lam
    contrib = jnp.where(pair, ndim * rho[None, :] * S * wkern, 0.0)
    a_drag = -jnp.sum(contrib[..., None] * unit, axis=1)
    if test_particle:
        a_drag = jnp.where(is_dust[:, None], a_drag, 0.0)

    # dust timestep criteria (Dust.cpp:1070-1076)
    dvmag = jnp.sqrt(jnp.maximum(drsqd * 0 + jnp.sum(dv * dv, -1), 0.0))
    sound_d = jnp.max(jnp.where(pair, gsound, 0.0), axis=1)
    div_v_d = jnp.max(jnp.where(pair, dvmag, 0.0), axis=1) \
        / jnp.maximum(h, 1e-30)

    # drag heating (Dust.cpp:1109-1133): each particle's kinetic-energy
    # change; gas keeps its own, dust deposits onto gas neighbours
    dudt = jnp.zeros_like(m)
    if law.use_energy_term and not test_particle:
        # v0 + a dt with v0 the kick-start velocity (Dust.cpp:110-111)
        v_end = v - 0.5 * dt * a0 + a * dt
        dEk = jnp.sum(a_drag * (v_end + 0.5 * a_drag * dt), axis=-1)   # (N,)
        dudt = jnp.where(is_gas, -dEk, 0.0)
        # deposit weight uses the RAW drag kernel over the m/rho-weighted
        # norm so that sum_j m_j w~_ij = 1 exactly (Dust.cpp:1119-1127)
        norm = jnp.sum(wkern, axis=1)
        spread = wraw / (jnp.maximum(norm, 1e-30)[:, None]
                         * jnp.maximum(rho[None, :], 1e-30))
        # dust i deposits -m_i * dEk_i onto each gas j
        dep = jnp.where(is_dust[:, None], spread
                        * (m * dEk)[:, None], 0.0)
        dudt = dudt - jnp.sum(dep, axis=0)
    return DragResult(a_drag=a_drag, dudt=dudt,
                      sound=sound_d, div_v=div_v_d)


def drag_twofluid_view(kern: SmoothingKernel, law: DragLaw, dt: Array,
                       v: Array, a: Array, a0: Array, m: Array, h: Array,
                       rho: Array, sound: Array, ptype: Array,
                       dr: Array, cid: Array, nb: dict, mask: Array,
                       test_particle: bool = False,
                       dudt_size: int = None) -> DragResult:
    """Semi-implicit gas-dust drag over a per-row candidate VIEW (N, K)
    — the same physics as drag_twofluid with the (N, N) broadcasts
    replaced by gathered neighbour arrays (dr = r_j - r_i in the i-row
    frame is negated to the reference's r_i - r_j convention here).
    nb needs v/a/m/h/rho/sound/ptype; cid are global candidate indices
    (for the dust->gas energy deposit scatter).  Returns per-target
    DragResult; dudt has length dudt_size (the global N).  `dt` may be
    a scalar or per-target (N,) (the reference's per-active-particle
    drag_timestep, Dust.cpp:216-218)."""
    N, ndim = v.shape
    dt = jnp.broadcast_to(jnp.asarray(dt, v.dtype), (N,))[:, None]
    is_gas_i = ptype == GAS_TYPE
    is_dust_i = ptype == DUST_TYPE
    is_gas_j = nb["ptype"] == GAS_TYPE
    is_dust_j = nb["ptype"] == DUST_TYPE

    drij = -dr                                      # r_i - r_j
    drsqd = jnp.sum(drij * drij, axis=-1)
    pair = ((is_gas_i[:, None] & is_dust_j)
            | (is_dust_i[:, None] & is_gas_j)) & mask & (drsqd > 0.0)
    drmag = jnp.sqrt(jnp.where(drsqd > 0, drsqd, 1.0))
    unit = drij / drmag[..., None]

    h_gas = jnp.where(is_gas_i[:, None], h[:, None], nb["h"])
    h_gas = jnp.maximum(h_gas, 1e-30)
    invh = 1.0 / h_gas
    wraw = (invh ** ndim) * kern.wdrag(drmag * invh)
    wraw = jnp.where(pair, wraw, 0.0)
    wkern = wraw * nb["m"] / jnp.maximum(nb["rho"], 1e-30)

    # target row's dt on both sides (get_velocity_difference)
    da0 = a0[:, None, :] - nb["a0"]
    dv = v[:, None, :] - nb["v"] - 0.5 * dt[..., None] * da0
    da = a[:, None, :] - nb["a"]
    dvdr = jnp.sum(dv * unit, axis=-1)
    dadr = jnp.sum(da * unit, axis=-1)

    grho = jnp.where(is_gas_i[:, None], rho[:, None], nb["rho"])
    drho = jnp.where(is_gas_i[:, None], nb["rho"], rho[:, None])
    gsound = jnp.where(is_gas_i[:, None], sound[:, None], nb["sound"])
    if test_particle:
        drho = jnp.zeros_like(drho)
    t_s = jnp.maximum(law.t_stop(grho, drho, gsound), 1e-30)

    rho_t = grho + drho
    tau = dt / t_s
    dt_safe = jnp.maximum(dt, 1e-30)
    xi_big = (1.0 - jnp.exp(-tau)) / (dt_safe * rho_t)
    lam_big = (dt + t_s) * xi_big - 1.0 / rho_t
    xi_small0 = (1.0 - 0.5 * tau * (1.0 - tau / 3.0)) / rho_t
    lam_small = (1.0 + tau) * xi_small0 - 1.0 / rho_t
    xi_small = xi_small0 / t_s
    big = tau > 1e-3
    Xi = jnp.where(big, xi_big, xi_small)
    Lam = jnp.where(big, lam_big, lam_small)

    S = (dvdr + dt * dadr) * Xi - dadr * Lam
    contrib = jnp.where(pair, ndim * nb["rho"] * S * wkern, 0.0)
    a_drag = -jnp.sum(contrib[..., None] * unit, axis=1)
    if test_particle:
        a_drag = jnp.where(is_dust_i[:, None], a_drag, 0.0)

    dvmag = jnp.sqrt(jnp.maximum(jnp.sum(dv * dv, -1), 0.0))
    sound_d = jnp.max(jnp.where(pair, gsound, 0.0), axis=1)
    div_v_d = jnp.max(jnp.where(pair, dvmag, 0.0), axis=1) \
        / jnp.maximum(h, 1e-30)

    M = dudt_size or N
    dudt = jnp.zeros((M,), m.dtype)
    if law.use_energy_term and not test_particle:
        v_end = v - 0.5 * dt * a0 + a * dt
        dEk = jnp.sum(a_drag * (v_end + 0.5 * a_drag * dt), axis=-1)
        dudt = dudt.at[jnp.arange(N)].add(
            jnp.where(is_gas_i, -dEk, 0.0))
        norm = jnp.sum(wkern, axis=1)
        spread = wraw / (jnp.maximum(norm, 1e-30)[:, None]
                         * jnp.maximum(nb["rho"], 1e-30))
        dep = jnp.where(is_dust_i[:, None] & pair,
                        spread * (m * dEk)[:, None], 0.0)
        # dust row i deposits onto its GLOBAL gas candidates
        dudt = dudt.at[jnp.maximum(cid, 0).reshape(-1)].add(
            -dep.reshape(-1))
    return DragResult(a_drag=a_drag, dudt=dudt,
                      sound=sound_d, div_v=div_v_d)


def drag_pass_grid(kern: SmoothingKernel, law: DragLaw, spec, dt,
                   s, alive: Array, test_particle: bool,
                   box=None) -> DragResult:
    """Gas-dust drag over grid27 candidate gathers (the reference's
    dust-specific neighbour finder, src/Headers/Dust.h:46-358, on the
    structured grid instead of the O(N^2) fallback).

    Mirror walls (spec.mirror, requires `box`): the binning is extended
    with reflected image copies (the reference's mirror ghosts walk the
    drag tree too, Ghosts.cpp:161-202); images flip the wall-normal
    component of v AND a/a0 (the kick-start velocity difference uses
    both, Dust.cpp:52-55), and a dust row's energy deposit onto a gas
    IMAGE candidate is redirected to the image's parent (the symmetric
    image-pair contribution)."""
    from . import sph_grid27 as g
    from .active_grid import gather_active_candidates

    N = s.N
    if spec.mirror:
        walls = box.mirror_walls()
        parts = {"r": [s.r], "v": [s.v], "a": [s.a], "a0": [s.a0]}
        keeps = [alive]
        for (k, side) in walls:
            bound = box.boxmin[k] if side == 0 else box.boxmax[k]
            layers = spec.qz if k == 0 else 1
            cell_k = spec.extents[k] / spec.ncells[k]
            rad = layers * cell_k
            parts["r"].append(s.r.at[:, k].set(2.0 * bound - s.r[:, k]))
            for nm in ("v", "a", "a0"):
                w = getattr(s, nm)
                parts[nm].append(w.at[:, k].set(-w[:, k]))
            keeps.append(alive & (jnp.abs(s.r[:, k] - bound) < rad))
        n_rep = 1 + len(walls)
        tile = lambda x: jnp.tile(x, (n_rep,))
        ext = {nm: jnp.concatenate(ps, axis=0)
               for nm, ps in parts.items()}
        m_e, h_e = tile(s.m), tile(s.h)
        rho_e, snd_e, pt_e = tile(s.rho), tile(s.sound), tile(s.ptype)
        keep = jnp.concatenate(keeps, axis=0)
        b = g.bin_particles(spec, ext["r"], discard=~keep)
        idx = jnp.arange(N, dtype=jnp.int32)      # targets: parents only
        ag = gather_active_candidates(spec, b, ext["r"], idx, alive)
        cid = jnp.maximum(ag.ids, 0)
        nb = {
            "v": jnp.where(ag.mask[..., None], ext["v"][cid], 0.0),
            "a": jnp.where(ag.mask[..., None], ext["a"][cid], 0.0),
            "a0": jnp.where(ag.mask[..., None], ext["a0"][cid], 0.0),
            "m": jnp.where(ag.mask, m_e[cid], 0.0),
            "h": jnp.where(ag.mask, h_e[cid], 1.0),
            "rho": jnp.where(ag.mask, rho_e[cid], 1.0),
            "sound": jnp.where(ag.mask, snd_e[cid], 0.0),
            "ptype": jnp.where(ag.mask, pt_e[cid], -1),
        }
        return drag_twofluid_view(kern, law, dt, s.v, s.a, s.a0, s.m,
                                  s.h, s.rho, s.sound, s.ptype, ag.dr,
                                  jnp.where(ag.mask, cid % N, 0), nb,
                                  ag.mask, test_particle=test_particle,
                                  dudt_size=N)

    b = g.bin_particles(spec, s.r, discard=~alive)
    idx = jnp.arange(s.N, dtype=jnp.int32)
    ag = gather_active_candidates(spec, b, s.r, idx, alive)
    cid = jnp.maximum(ag.ids, 0)
    nb = {
        "v": jnp.where(ag.mask[..., None], s.v[cid], 0.0),
        "a": jnp.where(ag.mask[..., None], s.a[cid], 0.0),
        "a0": jnp.where(ag.mask[..., None], s.a0[cid], 0.0),
        "m": jnp.where(ag.mask, s.m[cid], 0.0),
        "h": jnp.where(ag.mask, s.h[cid], 1.0),
        "rho": jnp.where(ag.mask, s.rho[cid], 1.0),
        "sound": jnp.where(ag.mask, s.sound[cid], 0.0),
        "ptype": jnp.where(ag.mask, s.ptype[cid], -1),
    }
    return drag_twofluid_view(kern, law, dt, s.v, s.a, s.a0, s.m, s.h,
                              s.rho, s.sound, s.ptype, ag.dr,
                              jnp.where(ag.mask, cid, 0), nb, ag.mask,
                              test_particle=test_particle,
                              dudt_size=s.N)


def drag_pass_dense(kern: SmoothingKernel, law: DragLaw, spec, dt,
                    binning, s, alive: Array, test_particle: bool,
                    ghost_fn=None) -> DragResult:
    """Gas-dust drag over DENSE shifted cell tensors (shard_map-safe:
    fields travel as ghosted tensors, no gather-by-global-id).  Same
    physics as drag_twofluid_view; the dust->gas energy deposit is
    re-expressed as a GATHER at the gas target (w_drag is symmetric in
    the pair since it always uses the gas side's h, Dust.cpp:1046-1050):
    each dust particle's payload P = m dEk / norm is exchanged through
    the ghost rings and gas targets sum wraw * P / rho."""
    from . import sph_grid27 as g

    nd = s.ndim
    ghost = ghost_fn or g.add_ghost_layers
    d = lambda x: g.to_dense(spec, binning, x)
    back = lambda x: g.from_dense(spec, binning, x)
    fill = g.dense_fill_mask(spec, binning) & d(alive)
    K = spec.k_cell
    shifts = g._shifts(nd, spec.qz)

    # dt may be scalar or per-particle (N,): the reference uses the
    # ACTIVE particle's own drag_timestep on both sides of the pair
    # (Dust.cpp:52-55,216-218), so v/a0 travel raw and the kick-start
    # difference forms per target row
    dt_r = jnp.broadcast_to(jnp.asarray(dt, s.r.dtype), (s.N,))
    r_d = d(s.r)
    v_d = d(s.v)
    a_d = d(s.a)
    a0_d = d(s.a0)
    gasf = d((s.ptype == GAS_TYPE).astype(s.r.dtype))
    dustf = d((s.ptype == DUST_TYPE).astype(s.r.dtype))
    # packed scalar channels: [m, h, rho, sound, gasf, dustf]
    pk = jnp.stack([d(s.m), d(s.h), d(s.rho), d(s.sound), gasf, dustf],
                   axis=-1)
    vec = jnp.concatenate([v_d, a_d, a0_d], axis=-1)

    rp = ghost(spec, r_d, shift_vec=True)
    vecp = ghost(spec, vec)
    pkp = ghost(spec, pk)
    fp_ = ghost(spec, fill)

    flat = lambda x: x.reshape((-1,) + x.shape[nd + 1:])
    Np = int(np_prod(spec.ncells)) * K
    r_f = flat(r_d)
    v_f = flat(v_d)
    a_f = flat(a_d)
    a0_f = flat(a0_d)
    dt_f = flat(d(dt_r))[:, None]                  # (Np, 1) target-row dt
    h_f = flat(pk[..., 1])
    rho_f = flat(pk[..., 2])
    snd_f = flat(pk[..., 3])
    m_f = flat(pk[..., 0])
    fill_f = flat(fill)
    is_gas_t = flat(gasf) > 0.5
    is_dust_t = flat(dustf) > 0.5
    is_gas_t = is_gas_t & fill_f
    is_dust_t = is_dust_t & fill_f

    def bc(x):
        return jnp.broadcast_to(
            x[..., None, :], x.shape[:nd] + (K,) + x.shape[nd:]
        ).reshape((Np, K) + x.shape[nd + 1:])

    def bcv(x):
        return jnp.broadcast_to(
            x[..., None, :, :], x.shape[:nd] + (K,) + x.shape[nd:]
        ).reshape((Np, K) + x.shape[nd + 1:])

    def pair_geom(sh):
        """Per-shift pair mask / kernel / geometry shared by both loops."""
        r_nb = g._shift_view(spec, rp, sh)
        pk_nb = g._shift_view(spec, pkp, sh)
        f_nb = g._shift_view(spec, fp_, sh)
        drij = (r_d[..., :, None, :]
                - r_nb[..., None, :, :]).reshape(Np, K, nd)   # r_i - r_j
        drsqd = jnp.sum(drij * drij, axis=-1)
        pkb = bcv(pk_nb)
        ok = bc(f_nb)
        gas_j = pkb[..., 4] > 0.5
        dust_j = pkb[..., 5] > 0.5
        pair = ((is_gas_t[:, None] & dust_j)
                | (is_dust_t[:, None] & gas_j)) & ok & (drsqd > 0.0)
        drmag = jnp.sqrt(jnp.where(drsqd > 0, drsqd, 1.0))
        unit = drij / drmag[..., None]
        h_gas = jnp.where(is_gas_t[:, None], h_f[:, None], pkb[..., 1])
        invh = 1.0 / jnp.maximum(h_gas, 1e-30)
        wraw = jnp.where(pair, (invh ** nd) * kern.wdrag(drmag * invh),
                         0.0)
        return pkb, pair, unit, wraw

    a_drag = jnp.zeros((Np, nd), r_f.dtype)
    norm = jnp.zeros((Np,), r_f.dtype)
    sound_d = jnp.zeros((Np,), r_f.dtype)
    divv_d = jnp.zeros((Np,), r_f.dtype)
    dt_safe = jnp.maximum(dt_f, 1e-30)
    for sh in shifts:
        pkb, pair, unit, wraw = pair_geom(sh)
        vec_nb = bcv(g._shift_view(spec, vecp, sh))
        wkern = wraw * pkb[..., 0] / jnp.maximum(pkb[..., 2], 1e-30)
        da0 = a0_f[:, None, :] - vec_nb[..., 2 * nd:]
        dv = (v_f[:, None, :] - vec_nb[..., :nd]
              - 0.5 * dt_f[..., None] * da0)
        da = a_f[:, None, :] - vec_nb[..., nd:2 * nd]
        dvdr = jnp.sum(dv * unit, axis=-1)
        dadr = jnp.sum(da * unit, axis=-1)
        grho = jnp.where(is_gas_t[:, None], rho_f[:, None], pkb[..., 2])
        drho = jnp.where(is_gas_t[:, None], pkb[..., 2], rho_f[:, None])
        gsound = jnp.where(is_gas_t[:, None], snd_f[:, None],
                           pkb[..., 3])
        if test_particle:
            drho = jnp.zeros_like(drho)
        t_s = jnp.maximum(law.t_stop(grho, drho, gsound), 1e-30)
        rho_t = grho + drho
        tau = dt_f / t_s
        xi_big = (1.0 - jnp.exp(-tau)) / (dt_safe * rho_t)
        lam_big = (dt_f + t_s) * xi_big - 1.0 / rho_t
        xi_small0 = (1.0 - 0.5 * tau * (1.0 - tau / 3.0)) / rho_t
        lam_small = (1.0 + tau) * xi_small0 - 1.0 / rho_t
        xi_small = xi_small0 / t_s
        big = tau > 1e-3
        Xi = jnp.where(big, xi_big, xi_small)
        Lam = jnp.where(big, lam_big, lam_small)
        S = (dvdr + dt_f * dadr) * Xi - dadr * Lam
        contrib = jnp.where(pair, nd * pkb[..., 2] * S * wkern, 0.0)
        a_drag = a_drag - jnp.sum(contrib[..., None] * unit, axis=1)
        norm = norm + jnp.sum(wkern, axis=1)
        sound_d = jnp.maximum(sound_d,
                              jnp.max(jnp.where(pair, gsound, 0.0), 1))
        dvmag = jnp.sqrt(jnp.maximum(jnp.sum(dv * dv, -1), 0.0))
        divv_d = jnp.maximum(divv_d,
                             jnp.max(jnp.where(pair, dvmag, 0.0), 1))
    divv_d = divv_d / jnp.maximum(h_f, 1e-30)
    if test_particle:
        a_drag = jnp.where(is_dust_t[:, None], a_drag, 0.0)

    dudt = jnp.zeros((Np,), r_f.dtype)
    if law.use_energy_term and not test_particle:
        v_end = v_f + (a_f - 0.5 * a0_f) * dt_f
        dEk = jnp.sum(a_drag * (v_end + 0.5 * a_drag * dt_f), axis=-1)
        dudt = jnp.where(is_gas_t, -dEk, 0.0)
        payload = jnp.where(is_dust_t,
                            m_f * dEk / jnp.maximum(norm, 1e-30), 0.0)
        pp = ghost(spec, payload.reshape(spec.ncells + (K,)))
        dep = jnp.zeros((Np,), r_f.dtype)
        for sh in shifts:
            _, pair, _, wraw = pair_geom(sh)
            p_nb = bc(g._shift_view(spec, pp, sh))
            dep = dep + jnp.sum(jnp.where(pair, wraw * p_nb, 0.0), 1)
        dudt = dudt - dep / jnp.maximum(rho_f, 1e-30)

    shp = spec.ncells + (K,)
    z = lambda x: jnp.where(alive, back(x.reshape(shp)), 0.0)
    return DragResult(
        a_drag=jnp.where(alive[:, None],
                         back(a_drag.reshape(shp + (nd,))), 0.0),
        dudt=z(dudt), sound=z(sound_d), div_v=z(divv_d))
