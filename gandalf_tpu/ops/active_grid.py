"""Active-subset hydro pass over the structured grid — the piece that
makes block timesteps PAY.

The reference's entire purpose for hierarchical timesteps is that only
active particles (dn == nstep) recompute densities/forces each tick
(Simulation::ComputeBlockTimesteps, src/Common/Simulation.cpp:1763-2197;
the per-cell walks in GradhSphTree.cpp:82-657 iterate ACTIVE cells only).
Round-2's block scheme had the bookkeeping but ran the full force pass
every tick.

Dense formulation: all particles are binned into the grid27 dense
cell tensors (O(N) scatter — cheap), and the pair work is GATHERED for a
host-compacted, padded index list of active particles only:

    candidates(i) = the (2qz+1)*3^(nd-1) shifted cells around i's cell,
    read from the ghosted dense tensors with one advanced-indexing gather
    of shape (n_active_cap, S*K).

The physics is the all-pairs module's (ops.density.compute_h /
ops.forces.compute_hydro_forces) applied to the gathered views, so the
compacted path cannot drift from the oracle.  Pair cost per tick is
O(n_active * S * K) — proportional to the active fraction.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..kernels.smoothing import SmoothingKernel
from . import sph_grid27 as g
from .density import compute_h
from .forces import ArtificialViscosity, NeighborView, compute_hydro_forces

Array = jnp.ndarray


class ActiveGather(NamedTuple):
    """Per-active-particle candidate gather (n_cap, S*K)."""

    ids: Array       # global particle index of each candidate, -1 invalid
    dr: Array        # r_cand - r_i with periodic image shifts applied
    mask: Array      # candidate validity


def _cell_coords(spec, cell_of):
    """Flat cell id -> per-dim integer coords."""
    coords = []
    rem = cell_of
    for n in reversed(spec.ncells[1:]):
        coords.append(rem % n)
        rem = rem // n
    coords.append(rem)
    return list(reversed(coords))      # [c0, c1, ...]


def gather_active_candidates(spec, b: g.GridBinning, r: Array,
                             idx: Array, valid: Array) -> ActiveGather:
    """Candidate neighbour gather for the compacted active subset.

    idx: (n_cap,) global particle indices (padded; `valid` masks pads).
    """
    nd = spec.ndim
    K = spec.k_cell
    N = r.shape[0]

    r_d = g.to_dense(spec, b, r)
    ids_d = g.to_dense(spec, b, jnp.arange(N, dtype=jnp.int32) + 1)
    fill = g.dense_fill_mask(spec, b)
    ids_d = jnp.where(fill, ids_d, 0)

    rg = g.add_ghost_layers(spec, r_d, shift_vec=True)
    idg = g.add_ghost_layers(spec, ids_d)      # open-dim pads -> 0

    safe_idx = jnp.maximum(idx, 0)
    coords = _cell_coords(spec, b.cell_of[safe_idx])   # list of (n_cap,)
    shifts = g._shifts(nd, spec.qz)
    S = len(shifts)
    # ghosted coordinates per shift: coord + shift offset
    gather_ix = []
    for k in range(nd):
        offs = jnp.asarray([sh[k] for sh in shifts], jnp.int32)  # (S,)
        gather_ix.append(coords[k][:, None] + offs[None, :])     # (n_cap,S)
    cand_r = rg[tuple(gather_ix)]          # (n_cap, S, K, nd)
    cand_id = idg[tuple(gather_ix)] - 1    # (n_cap, S, K)

    n_cap = idx.shape[0]
    cand_r = cand_r.reshape(n_cap, S * K, nd)
    cand_id = cand_id.reshape(n_cap, S * K)
    dr = cand_r - r[safe_idx][:, None, :]
    mask = (cand_id >= 0) & valid[:, None]
    return ActiveGather(ids=jnp.where(mask, cand_id, -1), dr=dr, mask=mask)


def active_hydro_pass(kern: SmoothingKernel, visc: ArtificialViscosity,
                      spec, eos, h_fac: float, h_converge: float,
                      s, idx: Array, valid: Array,
                      hydro_forces: bool = True):
    """Density + EOS + hydro forces for the active subset only.

    Returns (s_updated, levelneib_scatter, overflow).  Only rows `idx`
    (where valid) of the particle state are modified; everyone else keeps
    their last-updated values, exactly like the reference's inactive
    particles."""
    nd = s.ndim
    alive = s.alive
    b = g.bin_particles(spec, s.r, discard=~alive)
    hmax = g.hmax_of(spec, kern.kernrange)
    ag = gather_active_candidates(spec, b, s.r, idx, valid)
    safe = jnp.maximum(idx, 0)
    cid = jnp.maximum(ag.ids, 0)

    drsqd = jnp.sum(ag.dr * ag.dr, axis=-1)
    m_cand = jnp.where(ag.mask, s.m[cid], 0.0)

    dens = compute_h(kern, nd, h_fac, h_converge,
                     s.m[safe], s.h[safe], drsqd, m_cand,
                     mask=ag.mask, hmax=hmax)
    eos_kw = {}
    if getattr(eos, "needs_ionfrac", False):
        eos_kw["ionfrac"] = s.ionfrac[safe]
    u_a, press_a, sound_a = eos.thermal_update(
        jnp.maximum(dens.rho, 1e-30), s.u[safe], **eos_kw)

    # write the active rows back so the force pass sees FRESH target and
    # neighbour values for every particle active this tick (the reference
    # updates all active densities before any forces)
    put = lambda f, v: f.at[safe].set(jnp.where(valid, v, f[safe]))
    putv = lambda f, v: f.at[safe].set(
        jnp.where(valid[:, None], v, f[safe]))
    s = s.replace(h=put(s.h, dens.h), rho=put(s.rho, dens.rho),
                  invomega=put(s.invomega, dens.invomega),
                  zeta=put(s.zeta, dens.zeta),
                  hfactor=put(s.hfactor, dens.hfactor),
                  u=put(s.u, u_a), pressure=put(s.pressure, press_a),
                  sound=put(s.sound, sound_a))

    h_j = jnp.where(ag.mask, s.h[cid], 1.0)

    def scatter_levelneib(s):
        # Saitoh-Makino levelneib in BOTH directions (GradhSph.cpp:461)
        within = ag.mask & (drsqd <= (kern.kernrange
                                      * jnp.maximum(dens.h[:, None],
                                                    h_j)) ** 2)
        lvl_cand = jnp.where(within, s.level[cid], 0)
        lneib = s.levelneib.at[safe].max(
            jnp.where(valid, jnp.max(lvl_cand, axis=1), 0))
        lvl_active = jnp.where(valid, s.level[safe], 0)
        flat_ids = jnp.where(within, cid, 0)
        lneib = lneib.at[flat_ids.reshape(-1)].max(
            jnp.where(within, lvl_active[:, None], 0).reshape(-1))
        return s.replace(levelneib=lneib)

    if not hydro_forces:
        z = jnp.zeros_like(s.a[safe])
        s = s.replace(a=putv(s.a, z), dudt=put(s.dudt, dens.h * 0.0),
                      div_v=put(s.div_v, dens.h * 0.0))
        s = scatter_levelneib(s)
        overflow = b.overflow | jnp.any(
            jnp.where(valid, ~dens.converged, False)) | jnp.any(
            jnp.where(valid, dens.h, 0.0) > 0.99 * hmax)
        return s, overflow

    nb = NeighborView(
        dr=ag.dr,
        v=jnp.where(ag.mask[..., None], s.v[cid], 0.0),
        m=m_cand,
        h=h_j,
        rho=jnp.where(ag.mask, s.rho[cid], 1.0),
        u=jnp.where(ag.mask, s.u[cid], 0.0),
        pressure=jnp.where(ag.mask, s.pressure[cid], 0.0),
        sound=jnp.where(ag.mask, s.sound[cid], 0.0),
        invomega=jnp.where(ag.mask, s.invomega[cid], 1.0),
        hfactor=jnp.where(ag.mask, s.hfactor[cid], 0.0),
        alpha=jnp.where(ag.mask, s.alpha[cid], 0.0),
        mask=ag.mask)
    f = compute_hydro_forces(kern, visc,
                             s.v[safe], s.h[safe], s.rho[safe], s.u[safe],
                             s.pressure[safe], s.sound[safe],
                             s.invomega[safe], s.hfactor[safe],
                             s.alpha[safe], nb)
    s = s.replace(a=putv(s.a, f.a), dudt=put(s.dudt, f.dudt),
                  div_v=put(s.div_v, f.div_v))

    s = scatter_levelneib(s)

    overflow = b.overflow | jnp.any(
        jnp.where(valid, ~dens.converged, False)) | jnp.any(
        jnp.where(valid, dens.h, 0.0) > 0.99 * hmax)
    return s, overflow
