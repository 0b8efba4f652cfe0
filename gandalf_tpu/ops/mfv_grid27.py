"""Structured 27-shift neighbour drivers for the meshless finite-volume
scheme — the dense-grid analogue of MeshlessFVTree's three tree passes
(reference src/MeshlessFV/MeshlessFVTree.cpp:318 UpdateAllProperties,
:487 UpdateGradientMatrices, :662 UpdateGodunovFluxes).

Same formulation as the SPH grid (ops/sph_grid27.py): particles are
scattered into dense (*ncells, K, ...) cell tensors, one ghost layer is
added per face, and every neighbour access is a STATIC slice of the
ghosted tensor over the 3^ndim shifts — no gathers in the hot loop.  The
physics is shared with the all-pairs oracle through ops.mfv's
accumulate/finalize split (gradient_init/accumulate/finalize) and
compute_godunov_fluxes, so the two paths cannot drift apart.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.smoothing import SmoothingKernel
from . import mfv as mfv_ops
from .sph_grid27 import (Grid27Spec, _auto_slab, _shift_view, _shifts,
                         add_ghost_layers)

Array = jnp.ndarray

ITER_FP = 30
ITER_MAX = 150


class MfvGridDensity(NamedTuple):
    """Dense (*ncells, K) MFV density-pass results."""

    h: Array
    ndens: Array
    rho: Array
    invomega: Array
    zeta: Array
    hfactor: Array
    overflow: Array


def _slab_plumbing(spec: Grid27Spec, slab_chunk=None):
    n0 = spec.ncells[0]
    if slab_chunk is None:
        slab_chunk = _auto_slab(spec)
    slab_chunk = min(slab_chunk, n0)
    n_slabs = -(-n0 // slab_chunk)
    pad0 = n_slabs * slab_chunk - n0

    def pad_first(x, fill_val=0):
        widths = [(0, pad0)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill_val)

    qz = spec.qz

    def slab_view(x_p, s, c):
        return jax.lax.dynamic_slice_in_dim(x_p, s * c, c + 2 * qz, axis=0)

    def centre_view(x, s, c):
        return jax.lax.dynamic_slice_in_dim(pad_first(x), s * c, c, axis=0)

    return slab_chunk, n_slabs, pad_first, slab_view, centre_view


def density_mfv_grid27(kern: SmoothingKernel, spec: Grid27Spec,
                       h_fac: float, h_converge: float,
                       r_d: Array, m_d: Array, h_d: Array, fill: Array,
                       hmax: float, slab_chunk: int = None,
                       ghost_fn=None, count_fill: Array = None) -> MfvGridDensity:
    """Number-density h iteration over the structured grid
    (MfvCommon::ComputeH, MfvCommon.cpp:105-240): h = h_fac / ndens^(1/nd),
    with the omega/zeta grad-h corrections on the NUMBER density.

    `count_fill` (optional, defaults to `fill`) restricts the overflow
    check to a subset of filled slots — the mirror path's parent rows
    (edge-of-band image copies legitimately miss their own second-layer
    neighbours and run h past hmax; their h result is discarded)."""
    nd = spec.ndim
    invndim = 1.0 / nd
    ghost = ghost_fn or add_ghost_layers
    rp_full = ghost(spec, r_d, shift_vec=True)
    mp_full = ghost(spec, m_d)
    fp_full = ghost(spec, fill)
    mp_full = jnp.where(fp_full, mp_full, 0.0)

    c0, n_slabs, pad_first, slab_view, centre_view = \
        _slab_plumbing(spec, slab_chunk)
    rp_full = pad_first(rp_full)
    mp_full = pad_first(mp_full)
    fp_full = pad_first(fp_full)

    shifts = _shifts(nd, spec.qz)

    def slab_fn(s):
        c = c0
        rp = slab_view(rp_full, s, c)
        mp = slab_view(mp_full, s, c)
        fp = slab_view(fp_full, s, c)
        r_dc = centre_view(r_d, s, c)
        fill_c = centre_view(fill, s, c)
        h_dc = jax.lax.dynamic_slice_in_dim(pad_first(h_d, 1), s * c, c,
                                            axis=0)
        sub = dataclasses.replace(spec, ncells=(c,) + spec.ncells[1:])

        def sums_at(h):
            invh = 1.0 / h
            invhsqd = invh * invh
            ndens = jnp.zeros_like(h)
            invom = jnp.zeros_like(h)
            zeta = jnp.zeros_like(h)
            for sh in shifts:
                r_nb = _shift_view(sub, rp, sh)
                m_nb = _shift_view(sub, mp, sh)
                f_nb = _shift_view(sub, fp, sh)
                dr = r_nb[..., None, :, :] - r_dc[..., :, None, :]
                ssqd = jnp.sum(dr * dr, axis=-1) * invhsqd[..., None]
                ok = f_nb[..., None, :]
                ndens = ndens + jnp.sum(
                    jnp.where(ok, kern.w0_s2(ssqd), 0.0), -1)
                invom = invom + jnp.sum(
                    jnp.where(ok, kern.womega_s2(ssqd), 0.0), -1)
                zeta = zeta + jnp.sum(
                    jnp.where(ok, m_nb[..., None, :] * kern.wzeta_s2(ssqd),
                              0.0), -1)
            hfac = invh ** nd
            return ndens * hfac, invom * hfac * invh, zeta * invhsqd

        def h_target(ndens):
            return h_fac * (1.0 / jnp.maximum(ndens, 1e-300)) ** invndim

        def body(carry):
            h, _, _, _, lo, hi, it, done = carry
            ndens, invom, zeta = sums_at(h)
            tgt = h_target(ndens)
            conv = (ndens > 0.0) & (jnp.abs(h - tgt) < h_converge)
            too_big = (ndens < 1e-30) | (ndens * h ** nd > h_fac ** nd)
            start_bis = it >= ITER_FP
            hi_n = jnp.where(start_bis & too_big & ~conv, h, hi)
            lo_n = jnp.where(start_bis & ~too_big & ~conv, h, lo)
            h_new = jnp.where(it < ITER_FP, tgt, 0.5 * (lo_n + hi_n))
            h_out = jnp.where(conv | done, h,
                              jnp.clip(h_new, 1e-6 * hmax, hmax))
            return (h_out, ndens, invom, zeta, lo_n, hi_n, it + 1,
                    done | conv)

        def cond(carry):
            *_, it, done = carry
            return (it < ITER_MAX) & ~jnp.all(done)

        h0 = jnp.clip(jnp.where(fill_c, h_dc, 0.5 * hmax),
                      1e-6 * hmax, hmax)
        z = jnp.zeros_like(h0)
        carry0 = (h0, z, z, z, jnp.zeros_like(h0),
                  jnp.full_like(h0, hmax), jnp.asarray(0), ~fill_c)
        h, ndens, invom, zeta, lo, hi, it, done = jax.lax.while_loop(
            cond, body, carry0)
        return h, ndens, invom, zeta, done

    h, ndens, invom, zeta, done = jax.lax.map(
        slab_fn, jnp.arange(n_slabs, dtype=jnp.int32))
    n0 = spec.ncells[0]
    unpad = lambda x: x.reshape((n_slabs * c0,) + x.shape[2:])[:n0]
    h, ndens, invom, zeta, done = map(unpad, (h, ndens, invom, zeta, done))

    ndens_safe = jnp.maximum(ndens, 1e-300)
    h_final = h_fac * (1.0 / ndens_safe) ** invndim
    invh = 1.0 / h_final
    hfactor = invh ** (nd + 1)
    rho = m_d * ndens
    # Omega correction on number density (MfvCommon.cpp:199-205)
    invomega = 1.0 / (1.0 + invndim * h_final * invom / ndens_safe)
    zeta_final = -invndim * m_d * h_final * zeta * invomega / ndens_safe
    cfill = fill if count_fill is None else count_fill
    overflow = jnp.any(jnp.where(cfill, ~done, False)) | \
        jnp.any(jnp.where(cfill, h_final, 0.0) > 0.99 * hmax)
    sane = lambda x, v: jnp.where(fill, x, v)
    return MfvGridDensity(h=sane(h_final, 1.0), ndens=sane(ndens, 1.0),
                          rho=sane(rho, 1.0), invomega=sane(invomega, 1.0),
                          zeta=sane(zeta_final, 0.0),
                          hfactor=sane(hfactor, 0.0), overflow=overflow)


class MfvGridGradients(NamedTuple):
    """Dense (*ncells, K, ...) gradient-pass results."""

    B: Array
    grad: Array
    alpha_slope: Array
    vsig_max: Array
    bad: Array


def gradients_mfv_grid27(kern: SmoothingKernel, spec: Grid27Spec,
                         dense: dict, fill: Array,
                         slab_chunk: int = None,
                         ghost_fn=None,
                         limiter: str = "scalar") -> MfvGridGradients:
    """Least-squares gradient matrices + cell limiter over the grid
    (MeshlessFVTree::UpdateGradientMatrices).  dense needs r, h, ndens,
    Wprim (*nc, K, nvar), sound.  `limiter` = "tvdscalar"/"springel2009"
    adds the per-neighbour alpha sweep (SlopeLimiter.h:127-342) as a
    second shift pass once the gradients are known."""
    nd = spec.ndim
    nvar = nd + 2
    ghost = ghost_fn or add_ghost_layers
    # packed neighbour tensor: [Wprim (nvar), sound]
    packed = jnp.concatenate(
        [dense["Wprim"], dense["sound"][..., None]], axis=-1)
    rp_full = ghost(spec, dense["r"], shift_vec=True)
    pkp_full = ghost(spec, packed)
    fp_full = ghost(spec, fill)

    c0, n_slabs, pad_first, slab_view, centre_view = \
        _slab_plumbing(spec, slab_chunk)
    rp_full = pad_first(rp_full)
    pkp_full = pad_first(pkp_full)
    fp_full = pad_first(fp_full)
    K = spec.k_cell
    shifts = _shifts(nd, spec.qz)

    def slab_fn(s):
        c = c0
        rp, pkp, fp = slab_view(rp_full, s, c), slab_view(pkp_full, s, c), \
            slab_view(fp_full, s, c)
        sub = dataclasses.replace(spec, ncells=(c,) + spec.ncells[1:])
        r_t = centre_view(dense["r"], s, c)
        h_t = jnp.maximum(centre_view(dense["h"], s, c), 1e-30)
        nden_t = centre_view(dense["ndens"], s, c)
        W_t = centre_view(dense["Wprim"], s, c)
        snd_t = centre_view(dense["sound"], s, c)

        flat = lambda x: x.reshape((-1,) + x.shape[nd + 1:])
        h_f = flat(h_t)
        acc = mfv_ops.gradient_init(h_f.shape[0], nd, h_f.dtype)
        Wp_f = flat(W_t)
        snd_f = flat(snd_t)
        nden_f = flat(nden_t)
        for sh in shifts:
            r_nb = _shift_view(sub, rp, sh)
            pk_nb = _shift_view(sub, pkp, sh)
            f_nb = _shift_view(sub, fp, sh)
            dr = r_nb[..., None, :, :] - r_t[..., :, None, :]
            # flatten (cells, K_t) -> N', keep K_nb as the view axis
            drf = dr.reshape(-1, K, nd)
            Wj = jnp.broadcast_to(pk_nb[..., None, :, :nvar],
                                  dr.shape[:-1] + (nvar,)).reshape(
                                      -1, K, nvar)
            sj = jnp.broadcast_to(pk_nb[..., None, :, nvar],
                                  dr.shape[:-1]).reshape(-1, K)
            vj = Wj[..., :nd]
            maskf = jnp.broadcast_to(f_nb[..., None, :],
                                     dr.shape[:-1]).reshape(-1, K)
            acc = mfv_ops.gradient_accumulate(
                kern, nd, acc, h_f, nden_f, Wp_f, snd_f,
                drf, Wj, sj, vj, maskf)
        return acc

    acc = jax.lax.map(slab_fn, jnp.arange(n_slabs, dtype=jnp.int32))
    n0 = spec.ncells[0]
    rest = 1
    for n in spec.ncells[1:]:
        rest *= n

    def unpad(x):
        # (n_slabs, c0*rest*K, ...) -> (total_cells*K, ...)
        x = x.reshape((n_slabs * c0, rest * K) + x.shape[2:])[:n0]
        return x.reshape((n0 * rest * K,) + x.shape[2:])

    acc = mfv_ops.GradAccum(*[unpad(x) for x in acc])
    h_f = jnp.maximum(dense["h"].reshape(-1), 1e-30)
    W_f = dense["Wprim"].reshape(-1, nvar)
    snd_f = dense["sound"].reshape(-1)
    res = mfv_ops.gradient_finalize(nd, acc, h_f, W_f, snd_f)
    shp = spec.ncells + (K,)

    if limiter in ("tvdscalar", "springel2009"):
        # second shift sweep with the finalised gradients: per-neighbour
        # alpha min (the reference iterates the neighbour list again in
        # CellLimiter once ComputeGradients has inverted E)
        grad_d = res.grad.reshape(shp + (nvar, nd))
        Wmax = jnp.maximum(acc.Wmax, W_f)
        Wmin = jnp.minimum(acc.Wmin, W_f)
        dWmax_d = (Wmax - W_f).reshape(shp + (nvar,))
        dWmin_d = (Wmin - W_f).reshape(shp + (nvar,))

        def alpha_slab(s):
            c = c0
            rp, pkp, fp = slab_view(rp_full, s, c), \
                slab_view(pkp_full, s, c), slab_view(fp_full, s, c)
            sub = dataclasses.replace(spec, ncells=(c,) + spec.ncells[1:])
            r_t = centre_view(dense["r"], s, c)
            h_t = jnp.maximum(centre_view(dense["h"], s, c), 1e-30)
            W_t = centre_view(dense["Wprim"], s, c)
            g_t = centre_view(grad_d, s, c)
            dmx_t = centre_view(dWmax_d, s, c)
            dmn_t = centre_view(dWmin_d, s, c)
            flat = lambda x: x.reshape((-1,) + x.shape[nd + 1:])
            h_f2, Wp_f2 = flat(h_t), flat(W_t)
            g_f2 = flat(g_t)
            dmx_f2, dmn_f2 = flat(dmx_t), flat(dmn_t)
            alpha = jnp.ones((h_f2.shape[0], nvar), h_f2.dtype)
            for sh in shifts:
                r_nb = _shift_view(sub, rp, sh)
                pk_nb = _shift_view(sub, pkp, sh)
                f_nb = _shift_view(sub, fp, sh)
                dr = r_nb[..., None, :, :] - r_t[..., :, None, :]
                drf = dr.reshape(-1, K, nd)
                Wj = jnp.broadcast_to(pk_nb[..., None, :, :nvar],
                                      dr.shape[:-1] + (nvar,)).reshape(
                                          -1, K, nvar)
                maskf = jnp.broadcast_to(f_nb[..., None, :],
                                         dr.shape[:-1]).reshape(-1, K)
                alpha = mfv_ops.limiter_alpha_accumulate(
                    limiter, kern, nd, alpha, h_f2, Wp_f2, g_f2,
                    dmx_f2, dmn_f2, drf, Wj, maskf)
            return alpha

        alpha = jax.lax.map(alpha_slab,
                            jnp.arange(n_slabs, dtype=jnp.int32))
        res = res._replace(alpha_slope=unpad(alpha))

    return MfvGridGradients(
        B=res.B.reshape(shp + (nd, nd)),
        grad=res.grad.reshape(shp + (nvar, nd)),
        alpha_slope=res.alpha_slope.reshape(shp + (nvar,)),
        vsig_max=res.vsig_max.reshape(shp),
        bad=res.bad.reshape(shp))


class MfvGridFluxes(NamedTuple):
    dQdt: Array       # (*ncells, K, nvar)
    rdmdt_dot: Array  # (*ncells, K, ndim)
    dQ: Array = None      # block mode: committed per-step increments
    rdmdt: Array = None


def fluxes_mfv_grid27(kern: SmoothingKernel, cfg: mfv_ops.MfvConfig,
                      spec: Grid27Spec, dt, dense: dict, fill: Array,
                      slab_chunk: int = None,
                      ghost_fn=None) -> MfvGridFluxes:
    """MUSCL Godunov flux accumulation over the grid
    (MeshlessFVTree::UpdateGodunovFluxes).  dense needs r, h, ndens,
    hfactor, Wprim, sound, a0, B, grad, alpha_slope, bad (float 0/1).

    Block-timestep mode: dense additionally carries "dt_own" (the
    particle's current full step) and "start" (1.0 where the particle
    begins a step this tick); the kernel then commits per-pair
    increments with dt_pair = min(dt_i, dt_j) (see ops/mfv.py)."""
    nd = spec.ndim
    nvar = nd + 2
    K = spec.k_cell
    block = "dt_own" in dense
    ghost = ghost_fn or add_ghost_layers
    # packed neighbour tensor:
    # [h, ndens, hfactor, Wprim(nvar), sound, a0(nd), B(nd*nd),
    #  grad(nvar*nd), alpha(nvar), bad]
    cols = [dense["h"][..., None], dense["ndens"][..., None],
            dense["hfactor"][..., None], dense["Wprim"],
            dense["sound"][..., None], dense["a0"],
            dense["B"].reshape(dense["B"].shape[:-2] + (nd * nd,)),
            dense["grad"].reshape(dense["grad"].shape[:-2] + (nvar * nd,)),
            dense["alpha_slope"], dense["bad"][..., None]]
    if block:
        cols += [dense["dt_own"][..., None], dense["start"][..., None]]
    packed = jnp.concatenate(cols, axis=-1)
    o_h, o_nden, o_hfac = 0, 1, 2
    o_W = 3
    o_snd = o_W + nvar
    o_a0 = o_snd + 1
    o_B = o_a0 + nd
    o_grad = o_B + nd * nd
    o_alpha = o_grad + nvar * nd
    o_bad = o_alpha + nvar
    o_dt, o_start = o_bad + 1, o_bad + 2

    rp_full = ghost(spec, dense["r"], shift_vec=True)
    pkp_full = ghost(spec, packed)
    fp_full = ghost(spec, fill)

    c0, n_slabs, pad_first, slab_view, centre_view = \
        _slab_plumbing(spec, slab_chunk)
    rp_full = pad_first(rp_full)
    pkp_full = pad_first(pkp_full)
    fp_full = pad_first(fp_full)
    shifts = _shifts(nd, spec.qz)

    def slab_fn(s):
        c = c0
        rp, pkp, fp = slab_view(rp_full, s, c), slab_view(pkp_full, s, c), \
            slab_view(fp_full, s, c)
        sub = dataclasses.replace(spec, ncells=(c,) + spec.ncells[1:])
        r_t = centre_view(dense["r"], s, c)
        flat = lambda x: x.reshape((-1,) + x.shape[nd + 1:])
        h_f = jnp.maximum(flat(centre_view(dense["h"], s, c)), 1e-30)
        nden_f = flat(centre_view(dense["ndens"], s, c))
        hfac_f = flat(centre_view(dense["hfactor"], s, c))
        W_f = flat(centre_view(dense["Wprim"], s, c))
        snd_f = flat(centre_view(dense["sound"], s, c))
        a0_f = flat(centre_view(dense["a0"], s, c))
        B_f = flat(centre_view(dense["B"], s, c))
        grad_f = flat(centre_view(dense["grad"], s, c))
        alpha_f = flat(centre_view(dense["alpha_slope"], s, c))
        bad_f = flat(centre_view(dense["bad"], s, c)) > 0.5
        r_f = flat(r_t)
        if block:
            dt_f = flat(centre_view(dense["dt_own"], s, c))
            start_f = flat(centre_view(dense["start"], s, c)) > 0.5

        Np = r_f.shape[0]
        dQdt = jnp.zeros((Np, nvar), r_f.dtype)
        rdmdt = jnp.zeros((Np, nd), r_f.dtype)
        dQi = jnp.zeros((Np, nvar), r_f.dtype) if block else None
        rdmi = jnp.zeros((Np, nd), r_f.dtype) if block else None
        for sh in shifts:
            r_nb = _shift_view(sub, rp, sh)
            pk_nb = _shift_view(sub, pkp, sh)
            f_nb = _shift_view(sub, fp, sh)
            dr = r_nb[..., None, :, :] - r_t[..., :, None, :]
            drf = dr.reshape(-1, K, nd)
            bshape = dr.shape[:-1]        # (cells..., K_t, K_nb)
            g = lambda sl: jnp.broadcast_to(
                pk_nb[..., None, :, sl],
                bshape + ((sl.stop - sl.start,)
                          if isinstance(sl, slice) else ())).reshape(
                    (-1, K) + ((sl.stop - sl.start,)
                               if isinstance(sl, slice) else ()))
            nb = {
                "h": g(o_h), "ndens": g(o_nden), "hfactor": g(o_hfac),
                "Wprim": g(slice(o_W, o_W + nvar)),
                "sound": g(o_snd),
                "a0": g(slice(o_a0, o_a0 + nd)),
                "B": g(slice(o_B, o_B + nd * nd)).reshape(-1, K, nd, nd),
                "grad": g(slice(o_grad, o_grad + nvar * nd)).reshape(
                    -1, K, nvar, nd),
                "alpha_slope": g(slice(o_alpha, o_alpha + nvar)),
                "bad": g(o_bad) > 0.5,
            }
            maskf = jnp.broadcast_to(f_nb[..., None, :], bshape).reshape(
                -1, K)
            kw = {}
            if block:
                dt_nb = g(o_dt)
                start_nb = g(o_start) > 0.5
                kw["dt_pair"] = jnp.minimum(dt_f[:, None], dt_nb)
                kw["pair_on"] = start_f[:, None] | start_nb
            res = mfv_ops.compute_godunov_fluxes(
                kern, cfg, nd, dt, r_f, h_f, nden_f, hfac_f, W_f, snd_f,
                a0_f, B_f, grad_f, alpha_f, bad_f, drf, nb, maskf, **kw)
            dQdt = dQdt + res.dQdt
            rdmdt = rdmdt + res.rdmdt_dot
            if block:
                dQi = dQi + res.dQ
                rdmi = rdmi + res.rdmdt
        if block:
            return dQdt, rdmdt, dQi, rdmi
        return dQdt, rdmdt

    out = jax.lax.map(slab_fn, jnp.arange(n_slabs, dtype=jnp.int32))
    n0 = spec.ncells[0]
    rest = 1
    for n in spec.ncells[1:]:
        rest *= n

    def unpad(x):
        x = x.reshape((n_slabs * c0, rest * K) + x.shape[2:])[:n0]
        return x.reshape(spec.ncells + (K,) + x.shape[2:])

    if block:
        dQdt, rdmdt, dQi, rdmi = out
        return MfvGridFluxes(dQdt=unpad(dQdt), rdmdt_dot=unpad(rdmdt),
                             dQ=unpad(dQi), rdmdt=unpad(rdmi))
    dQdt, rdmdt = out
    return MfvGridFluxes(dQdt=unpad(dQdt), rdmdt_dot=unpad(rdmdt))


# ---------------------------------------------------------------------------
# Conservative timestep limiter (time_step_limiter = conservative)
# ---------------------------------------------------------------------------

def vsig_near_grid27(spec: Grid27Spec, dense: dict, fill: Array,
                     ghost_fn=None) -> Array:
    """Near-field part of the distant-signal-velocity limiter: the exact
    per-pair formula over ALL particles in the shift neighbourhood (the
    leaf branch of Tree::ComputeSignalVelocityFromDistantInteractions,
    src/Tree/Tree.cpp:993-1023 — note this includes pairs beyond kernel
    range, scaled by h_i/max(|dr|, h_i)).

    dense: r, v, sound, h.  Returns the (*ncells, K) max contribution."""
    nd = spec.ndim
    ghost = ghost_fn or add_ghost_layers
    r_d, v_d = dense["r"], dense["v"]
    pk = jnp.concatenate([v_d, dense["sound"][..., None]], axis=-1)
    rp = ghost(spec, r_d, shift_vec=True)
    pkp = ghost(spec, pk)
    fp = ghost(spec, fill)
    K = spec.k_cell
    flat = lambda x: x.reshape((-1,) + x.shape[nd + 1:])
    Np = int(np.prod(spec.ncells)) * K
    r_f, v_f = flat(r_d), flat(v_d)
    snd_f = flat(dense["sound"])
    h_f = flat(dense["h"])
    vsig = jnp.zeros((Np,), r_f.dtype)
    for sh in _shifts(nd, spec.qz):
        r_nb = _shift_view(spec, rp, sh)
        pk_nb = _shift_view(spec, pkp, sh)
        f_nb = _shift_view(spec, fp, sh)
        # (cells*K_t, K_nb, ...) via broadcast over the target slot axis
        r_nbb = jnp.broadcast_to(
            r_nb[..., None, :, :],
            r_nb.shape[:nd] + (K, K, nd)).reshape(Np, K, nd)
        pk_nbb = jnp.broadcast_to(
            pk_nb[..., None, :, :],
            pk_nb.shape[:nd] + (K, K, nd + 1)).reshape(Np, K, nd + 1)
        ok = jnp.broadcast_to(
            f_nb[..., None, :],
            f_nb.shape[:nd] + (K, K)).reshape(Np, K)
        dr = r_nbb - r_f[:, None, :]
        drsqd = jnp.sum(dr * dr, axis=-1)
        drmag = jnp.sqrt(jnp.maximum(drsqd, 1e-300))
        dv = v_f[:, None, :] - pk_nbb[..., :nd]
        dvdr = jnp.sum(dv * dr, axis=-1) / drmag
        vs = snd_f[:, None] + pk_nbb[..., nd] - dvdr
        scale = h_f[:, None] / jnp.maximum(drmag, h_f[:, None])
        contrib = jnp.where(ok & (drsqd > 0), vs * scale, 0.0)
        vsig = jnp.maximum(vsig, jnp.max(contrib, axis=-1))
    return vsig.reshape(spec.ncells + (K,))


def vsig_cell_aggregates(spec: Grid27Spec, dense: dict, fill: Array):
    """Per-cell (maxsound, occ, vmax, vmin) aggregates for the far-field
    limiter bound.  `spec` may be a shard-local slab: the aggregates are
    purely per-cell, so the distributed pass all_gathers them and feeds
    the GLOBAL grid's geometry (vsig_far_from_agg)."""
    nd = spec.ndim
    C = int(np.prod(spec.ncells))
    K = spec.k_cell
    flatc = lambda x: x.reshape((C, K) + x.shape[nd + 1:])
    fillc = flatc(fill)
    snd = jnp.where(fillc, flatc(dense["sound"]), -1e30)
    maxsound = jnp.maximum(jnp.max(snd, axis=1), 0.0)
    occ = jnp.any(fillc, axis=1)
    v = flatc(dense["v"])
    big = 1e30
    vmax = jnp.max(jnp.where(fillc[..., None], v, -big), axis=1)
    vmin = jnp.min(jnp.where(fillc[..., None], v, big), axis=1)
    return maxsound, occ, vmax, vmin


def vsig_far_cells(spec: Grid27Spec, dense: dict, fill: Array):
    """Far-field cell-aggregate bound for the conservative limiter (the
    cell-opening branch of the reference walk, Tree.cpp:944-975, turned
    into a dense O(C^2) cell-pair pass with per-cell sound/velocity
    aggregates — conservative: the bound only over-limits, never under).

    Returns per-cell (A, Bc): a particle's far-field contribution is
    bounded by h_i * max(sound_i * A + Bc, 0)."""
    maxsound, occ, vmax, vmin = vsig_cell_aggregates(spec, dense, fill)
    return vsig_far_from_agg(spec, maxsound, occ, vmax, vmin)


def vsig_far_from_agg(spec: Grid27Spec, maxsound, occ, vmax, vmin):
    """The geometry half of vsig_far_cells: O(C^2) cell-pair pass over
    the FULL grid given per-cell aggregates (shape (C,) / (C, nd) in
    z-major cell order)."""
    nd = spec.ndim
    C = int(np.prod(spec.ncells))
    big = 1e30

    # cell centres / half-widths from the static geometry
    csize = np.array([spec.extents[k] / spec.ncells[k] for k in range(nd)])
    idx = np.stack(np.meshgrid(
        *[np.arange(n) for n in spec.ncells], indexing="ij"),
        axis=-1).reshape(C, nd)
    centres = jnp.asarray(np.array(spec.lo)[None, :]
                          + (idx + 0.5) * csize[None, :])
    ext = np.array(spec.extents)
    per = np.array(spec.periodic)

    dr = centres[None, :, :] - centres[:, None, :]          # (C, C, nd)
    for k in range(nd):
        if per[k]:
            dr = dr.at[..., k].set(
                dr[..., k] - ext[k] * jnp.round(dr[..., k] / ext[k]))
    gap = jnp.maximum(jnp.abs(dr) - jnp.asarray(csize)[None, None, :], 0.0)
    rmin = jnp.sqrt(jnp.maximum(jnp.sum(gap * gap, axis=-1), 1e-300))
    # exclude the shift neighbourhood (handled exactly by vsig_near)
    reach = jnp.asarray(csize * 1.0001)
    reach = reach.at[0].mul(float(spec.qz))
    near = jnp.all(jnp.abs(dr) <= reach[None, None, :], axis=-1)

    # dvdr bound (reference Tree.cpp:950-965): per dim, the approach
    # velocity bound between the facing box edges
    sgn_pos = dr > 0
    dv_edge = jnp.where(sgn_pos,
                        vmin[None, :, :] - vmax[:, None, :],
                        vmax[None, :, :] - vmin[:, None, :])
    gap_signed = jnp.where(sgn_pos, gap, -gap)
    dvdr = jnp.sum(gap_signed * dv_edge, axis=-1) / rmin
    valid = occ[None, :] & ~near
    inv_r = jnp.where(valid, 1.0 / rmin, 0.0)
    A = jnp.max(inv_r, axis=1)
    Bc = jnp.max(jnp.where(valid,
                           (maxsound[None, :] - dvdr) / rmin, -big), axis=1)
    return A, Bc
