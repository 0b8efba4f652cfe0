"""Cell-list SPH pipeline: chunked density + force passes.

The production counterpart of the all-pairs oracle in ops.density /
ops.forces (same physics functions, gathered neighbour views).  Particles
are processed in fixed-size chunks under `lax.map` so peak memory is
(chunk, 3^ndim * K_cell) regardless of N — the analogue of the
reference's per-cell OpenMP work batches (GradhSphTree.cpp:107-265).

The h-rho iteration runs chunk-locally: squared distances to the chunk's
candidates are computed once and reused across every iteration of the
`lax.while_loop` (the reference re-walks its neighbour list per particle
iteration; here the gather is hoisted).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..kernels.smoothing import SmoothingKernel
from ..state import DomainBox, SphState
from .celllist import CellList, GridSpec, build_cell_list, gather_candidates
from .density import compute_h
from .forces import ArtificialViscosity, NeighborView, compute_hydro_forces

Array = jnp.ndarray


class SortedDensity(NamedTuple):
    h: Array
    rho: Array
    invomega: Array
    zeta: Array
    hfactor: Array
    overflow: Array


def _pad_chunks(n: int, chunk: int) -> int:
    return (n + chunk - 1) // chunk * chunk


def density_pass(kern: SmoothingKernel, box: DomainBox, spec: GridSpec,
                 h_fac: float, h_converge: float,
                 cl: CellList, r_s: Array, m_s: Array, h_s: Array,
                 hmax: float, chunk: int = 4096) -> SortedDensity:
    """Chunked grad-h density/h iteration over sorted arrays."""
    N = r_s.shape[0]
    ndim = r_s.shape[1]
    Np = _pad_chunks(N, chunk)
    pad = Np - N

    def pad0(x, fill=0.0):
        if pad == 0:
            return x
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill)

    r_p = pad0(r_s)
    m_p = pad0(m_s, 1.0)
    h_p = pad0(h_s, 1.0)
    cell_p = pad0(cl.cell_of, 0)

    def chunk_fn(args):
        r_c, m_c, h_c, cell_c = args
        cand = gather_candidates(spec, cl, cell_c)
        r_j = r_s[cand.idx]                       # (chunk, K, ndim)
        dr = box.min_image(r_j - r_c[:, None, :])
        drsqd = jnp.sum(dr * dr, axis=-1)
        m_j = m_s[cand.idx]
        res = compute_h(kern, ndim, h_fac, h_converge, m_c, h_c,
                        drsqd, m_j, mask=cand.mask, hmax=hmax)
        return (res.h, res.rho, res.invomega, res.zeta, res.hfactor,
                res.converged)

    resh = lambda x: x.reshape(Np // chunk, chunk, *x.shape[1:])
    outs = jax.lax.map(chunk_fn, (resh(r_p), resh(m_p), resh(h_p),
                                  resh(cell_p)))
    h, rho, invom, zeta, hfac, conv = [o.reshape(Np, *o.shape[2:])[:N]
                                       for o in outs]
    overflow = cl.overflow | jnp.any(~conv) | jnp.any(h > 0.99 * hmax)
    return SortedDensity(h=h, rho=rho, invomega=invom, zeta=zeta,
                         hfactor=hfac, overflow=overflow)


def force_pass(kern: SmoothingKernel, visc: ArtificialViscosity,
               box: DomainBox, spec: GridSpec, cl: CellList,
               fields_s: dict, chunk: int = 4096):
    """Chunked hydro force pass over sorted arrays.

    fields_s: sorted per-particle arrays with keys r, v, m, h, rho, u,
    pressure, sound, invomega, hfactor, alpha.
    Returns (a, dudt, div_v, dalphadt) in sorted order.
    """
    r_s = fields_s["r"]
    N, ndim = r_s.shape
    Np = _pad_chunks(N, chunk)
    pad = Np - N

    def pad0(x, fill=0.0):
        if pad == 0:
            return x
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill)

    keys_i = ("r", "v", "m", "h", "rho", "u", "pressure", "sound",
              "invomega", "hfactor", "alpha")
    fills = {"h": 1.0, "rho": 1.0, "sound": 1.0, "invomega": 1.0,
             "hfactor": 1.0, "m": 0.0}
    padded = {k: pad0(fields_s[k], fills.get(k, 0.0)) for k in keys_i}
    padded["cell"] = pad0(cl.cell_of, 0)

    # Pack all scalar neighbour fields into one (N, F) matrix so each chunk
    # does a SINGLE gather of (chunk, K, F) instead of many separate giant
    # gathers — less HBM index traffic and far smaller fused-kernel state.
    scalar_keys = ("m", "h", "rho", "u", "pressure", "sound", "invomega",
                   "hfactor", "alpha")
    packed = jnp.stack([fields_s[k] for k in scalar_keys], axis=-1)  # (N, F)
    vecs = jnp.concatenate([fields_s["r"], fields_s["v"]], axis=-1)  # (N, 2d)

    def chunk_fn(args):
        c = dict(zip(list(keys_i) + ["cell"], args))
        cand = gather_candidates(spec, cl, c["cell"])
        nbr_vec = vecs[cand.idx]                    # (chunk, K, 2*ndim)
        nbr_sca = packed[cand.idx]                  # (chunk, K, F)
        dr = box.min_image(nbr_vec[..., :ndim] - c["r"][:, None, :])
        sca = {k: nbr_sca[..., i] for i, k in enumerate(scalar_keys)}
        nb = NeighborView(
            dr=dr, v=nbr_vec[..., ndim:], mask=cand.mask, **sca)
        f = compute_hydro_forces(kern, visc, c["v"], c["h"], c["rho"],
                                 c["u"], c["pressure"], c["sound"],
                                 c["invomega"], c["hfactor"], c["alpha"], nb)
        return f.a, f.dudt, f.div_v, f.dalphadt

    resh = lambda x: x.reshape(Np // chunk, chunk, *x.shape[1:])
    args = tuple(resh(padded[k]) for k in list(keys_i) + ["cell"])
    a, dudt, div_v, dalphadt = jax.lax.map(chunk_fn, args)
    unr = lambda x: x.reshape(Np, *x.shape[2:])[:N]
    return unr(a), unr(dudt), unr(div_v), unr(dalphadt)


def hydro_pass_celllist(kern, visc, box, spec, eos, h_fac, h_converge,
                        hydro_forces: bool, s: SphState,
                        chunk: int = 4096) -> SphState:
    """Full density -> EOS -> forces pass using the cell list.

    Sorts the state into cell order, runs the chunked passes, and scatters
    results back to the original particle order.
    """
    cl = build_cell_list(spec, s.r)
    p = cl.order                                  # sorted <- original
    hmax = min(spec.extents[k] / spec.ncells[k] for k in range(spec.ndim)) \
        / kern.kernrange

    r_s, v_s, m_s, h_s = s.r[p], s.v[p], s.m[p], s.h[p]
    dens = density_pass(kern, box, spec, h_fac, h_converge, cl,
                        r_s, m_s, h_s, hmax, chunk=chunk)
    u_s, pressure_s, sound_s = eos.thermal_update(dens.rho, s.u[p])

    inv = jnp.zeros_like(p).at[p].set(jnp.arange(p.shape[0], dtype=p.dtype))

    if hydro_forces:
        fields_s = {
            "r": r_s, "v": v_s, "m": m_s, "h": dens.h, "rho": dens.rho,
            "u": u_s, "pressure": pressure_s, "sound": sound_s,
            "invomega": dens.invomega, "hfactor": dens.hfactor,
            "alpha": s.alpha[p],
        }
        a_s, dudt_s, div_v_s, _ = force_pass(kern, visc, box, spec, cl,
                                             fields_s, chunk=chunk)
    else:
        a_s = jnp.zeros_like(r_s)
        dudt_s = jnp.zeros_like(m_s)
        div_v_s = jnp.zeros_like(m_s)

    # scatter back to original order
    back = lambda x: x[inv]
    return s.replace(
        h=back(dens.h), rho=back(dens.rho), invomega=back(dens.invomega),
        zeta=back(dens.zeta), hfactor=back(dens.hfactor),
        u=back(u_s), pressure=back(pressure_s), sound=back(sound_s),
        a=back(a_s), dudt=back(dudt_s), div_v=back(div_v_s),
        neib_overflow=dens.overflow)
