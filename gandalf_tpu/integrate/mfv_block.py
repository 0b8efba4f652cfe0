"""Hierarchical (block) timesteps for the meshless finite-volume scheme.

Vectorised formulation of MfvIntegration::AdvanceParticles / EndTimestep /
CheckTimesteps (reference src/MeshlessFV/MfvIntegration.cpp:44-260) on top
of the shared ladder bookkeeping in integrate/block.py (the analogue of
ComputeBlockTimesteps, src/Common/Simulation.cpp:1763-2197).

Per-particle flux bookkeeping (reference MeshlessFVParticle fields,
src/Headers/Particle.h:414-598):

- ``Qcons0``  conserved vector at the particle's own step start,
- ``dQ``      accumulated pair-flux exchange over the current step,
- ``dQdt``    flux rate snapshot from the step start (used to PREDICT the
              conserved state of mid-step particles each tick),
- ``rdmdt``   mass-flux moment for the gravitational correction.

Pair fluxes are committed with ``dt_pair = min(dt_i, dt_j)`` whenever the
deeper particle of the pair starts a step: by the power-of-two alignment
of the ladder, a shallower particle's step is tiled exactly by its deeper
neighbour's sub-steps, so the accumulated exchange covers each particle's
step and conservation is exact to roundoff (the reference reaches the
same tiling through its active-side scatter with `do_pair_once`,
MeshlessFVTree.cpp:580-607).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..state import MfvState
from .block import (BlockConfig, BlockSchedule, _pow2,
                    compute_timestep_level, ladder_update)

Array = jnp.ndarray


def init_schedule_mfv(cfg: BlockConfig, s: MfvState, dt_part: Array,
                      axis_name: str = None
                      ) -> Tuple[MfvState, BlockSchedule]:
    """Build the initial ladder (the reference's first
    ComputeBlockTimesteps resync branch) and zero the flux accumulators."""
    from jax import lax

    alive = s.alive
    big = jnp.asarray(1e30, dt_part.dtype)
    dtp = jnp.where(alive, dt_part, big)
    dt_min = jnp.min(dtp)
    if axis_name is not None:
        dt_min = lax.pmin(dt_min, axis_name)
    level_max = jnp.asarray(cfg.nlevels - 1, jnp.int32)
    dt_max = dt_min * _pow2(level_max).astype(dt_min.dtype)
    level = jnp.minimum(compute_timestep_level(dtp, dt_max), level_max)
    level = jnp.where(alive, level, level_max)
    nstep = _pow2(level_max - level)
    nresync = _pow2(level_max)
    dt_base = dt_max / nresync.astype(dt_max.dtype)
    sched = BlockSchedule(
        n=jnp.asarray(0, jnp.int32), level_max=level_max,
        nresync=nresync, dt_base=dt_base, dt_max=dt_max,
        nstep_part=nstep, dt_next=dtp)
    s = s.replace(level=level, levelneib=level,
                  nlast=jnp.zeros_like(level),
                  tlast=jnp.broadcast_to(s.t, s.m.shape).astype(s.m.dtype),
                  dQ=jnp.zeros_like(s.Qcons0),
                  dQdt=jnp.zeros_like(s.Qcons0),
                  rdmdt=jnp.zeros_like(s.r))
    return s, sched


def _grav_predict(ndim: int, Q0: Array, Q: Array, a0: Array,
                  dt_el: Array, dt_own: Array) -> Array:
    """Predictive gravitational source terms (AdvanceParticles branch,
    MfvIntegration.cpp:81-88): elapsed-time factor dt_el, own-step factor
    dt_own inside the quadratic terms, a0 on both ends."""
    irho, iE = ndim, ndim + 1
    dE = 0.5 * dt_el * (
        jnp.sum(a0 * (Q0[..., :ndim]
                      + 0.5 * Q0[..., irho, None] * a0
                      * dt_own[..., None]), -1)
        + jnp.sum(a0 * (Q[..., :ndim]
                        + 0.5 * Q[..., irho, None] * a0
                        * dt_own[..., None]), -1))
    dmom = 0.5 * (Q0[..., irho, None] + Q[..., irho, None]) * a0 \
        * dt_el[..., None]
    Q = Q.at[..., :ndim].add(dmom)
    Q = Q.at[..., iE].add(dE)
    return Q


def advance_mfv(s: MfvState, B: BlockSchedule
                ) -> Tuple[MfvState, Array, Array, Array]:
    """One tick of conserved-variable prediction + drift for ALL particles
    (MfvIntegration::AdvanceParticles).  Returns
    (state', active, t, Qcons) — Qcons is the predicted conserved vector
    (NOT committed; end_timestep_mfv recommits for enders with the fresh
    gravity)."""
    n = B.n + 1
    t = s.t + B.dt_base
    dn = (n - s.nlast).astype(s.m.dtype)
    dt_el = B.dt_base * dn                       # elapsed since own start
    dt_own = B.dt_base * B.nstep_part.astype(s.m.dtype)
    active = ((n - s.nlast) == B.nstep_part) & s.alive

    Q = jnp.where(active[:, None], s.Qcons0 + s.dQ,
                  s.Qcons0 + s.dQdt * dt_el[:, None])
    ndim = s.ndim
    Q = _grav_predict(ndim, s.Qcons0, Q, s.a0, dt_el, dt_own)
    from ..ops.mfv import state_from_qcons

    m, rho, v, u = state_from_qcons(ndim, Q, s.ndens)
    r = s.r0 + 0.5 * (s.v0 + v) * dt_el[:, None]
    s = s.replace(r=r, v=v, m=m, u=u)
    return s, active, t, Q


def check_timesteps_mfv(cfg: BlockConfig, s: MfvState, B: BlockSchedule,
                        active: Array) -> Tuple[Array, Array, Array,
                                                MfvState]:
    """Saitoh-Makino neighbour limiter (MfvIntegration::CheckTimesteps,
    MfvIntegration.cpp:215-260, timestep_limiter == "simple"): force-end
    the step of particles whose neighbours are more than level_diff_max
    levels deeper, when the truncated step stays level-synchronised.  The
    force-ended particles commit their PREDICTED exchange
    (dQ <- dQdt * dt elapsed).

    Returns (active', nstep_part', level', state')."""
    n = B.n + 1
    dn = n - s.nlast
    level_new = s.levelneib - cfg.level_diff_max
    nnewstep = _pow2(B.level_max - jnp.minimum(level_new, B.level_max))
    reduce_ = (~active) & s.alive \
        & ((s.levelneib - s.level) > cfg.level_diff_max) \
        & ((dn % nnewstep) == 0) & (dn > 0)
    dt_el = B.dt_base * dn.astype(s.m.dtype)
    dQ = jnp.where(reduce_[:, None], s.dQdt * dt_el[:, None], s.dQ)
    nstep = jnp.where(reduce_, dn, B.nstep_part)
    level = jnp.where(reduce_, level_new, s.level)
    return active | reduce_, nstep, level, s.replace(dQ=dQ)


def end_timestep_mfv(cfg: BlockConfig, eos, s: MfvState, B: BlockSchedule,
                     active: Array, level: Array, nstep_part: Array,
                     dt_crit: Array, t: Array,
                     dt_extra: Array = None, axis_name: str = None,
                     cooling_fn=None) -> Tuple[MfvState, BlockSchedule]:
    """Commit the conserved state of particles ending their step
    (MfvIntegration::EndTimestep: Qcons = Qcons0 + dQ + trapezoidal
    gravity + rdmdt correction; reset dQ/dQdt/rdmdt; freeze r0/v0/a0) and
    update the shared ladder.  cooling_fn(Qcons, ndens, gpot, dt_own), if
    given, folds a radiative source term into the committed conserved
    vector with the particle's OWN step length (the reference applies
    part.cooling at EndTimestep, MfvIntegration.cpp:88-89 +
    EnergyRadws<MeshlessFVParticle>, EnergyRadws.cpp:215-260)."""
    ndim = s.ndim
    n = B.n + 1
    dn = (n - s.nlast).astype(s.m.dtype)
    dt_own = B.dt_base * dn                     # actual step length ended

    Q = s.Qcons0 + s.dQ
    from ..ops.mfv import state_from_qcons

    Qg = gravity_source_terms_pp(ndim, dt_own, s.Qcons0, Q, s.a0, s.a,
                                 s.rdmdt)
    if cooling_fn is not None:
        Qg = cooling_fn(Qg, s.ndens, s.gpot, dt_own)
    m, rho, v, u = state_from_qcons(ndim, Qg, s.ndens)
    u2, pressure, sound = eos.thermal_update(jnp.maximum(rho, 1e-30), u)

    am = active[:, None]
    av = active
    upd = dict(
        m=jnp.where(av, m, s.m), v=jnp.where(am, v, s.v),
        u=jnp.where(av, u2, s.u),
        pressure=jnp.where(av, pressure, s.pressure),
        sound=jnp.where(av, sound, s.sound),
        Qcons0=jnp.where(am, Qg, s.Qcons0),
        r0=jnp.where(am, s.r, s.r0),
        v0=jnp.where(am, v, s.v0),
        a0=jnp.where(am, s.a, s.a0),
        rdmdt0=jnp.where(am, s.rdmdt, s.rdmdt0),
        rdmdt=jnp.where(am, 0.0, s.rdmdt),
        dQ=jnp.where(am, 0.0, s.dQ),
        dQdt=jnp.where(am, 0.0, s.dQdt))

    dt_next = jnp.where(active, dt_crit, B.dt_next)
    lad, B = ladder_update(cfg, B, s.alive, active, level, s.levelneib,
                           nstep_part, s.nlast, s.tlast, dt_next, n, t,
                           dt_extra=dt_extra, axis_name=axis_name)
    s = s.replace(t=t, dt=B.dt_base, **lad, **upd)
    return s, B


def gravity_source_terms_pp(ndim: int, dt: Array, Q0: Array, Q: Array,
                            a0: Array, a: Array, rdmdt: Array) -> Array:
    """gravity_source_terms with a PER-PARTICLE dt (the block-mode commit;
    MfvIntegration.cpp:165-175 uses part.dt)."""
    irho, iE = ndim, ndim + 1
    dtc = dt[..., None]
    dE = 0.5 * dt * (
        jnp.sum(a0 * (Q0[..., :ndim]
                      + 0.5 * Q0[..., irho, None] * a0 * dtc), -1)
        + jnp.sum(a * (Q[..., :ndim]
                       + 0.5 * Q[..., irho, None] * a * dtc), -1))
    dE = dE + 0.5 * jnp.sum((a0 + a) * rdmdt, -1)
    dmom = 0.5 * dtc * (Q0[..., irho, None] * a0 + Q[..., irho, None] * a)
    Q = Q.at[..., :ndim].add(dmom)
    Q = Q.at[..., iE].add(dE)
    return Q


def vsig_distant_dense(box, r: Array, v: Array, h: Array, sound: Array,
                       alive: Array) -> Array:
    """All-pairs distant signal-velocity bound (the oracle for the
    `time_step_limiter = conservative` walk,
    Tree::ComputeSignalVelocityFromDistantInteractions,
    src/Tree/Tree.cpp:891-1040 leaf branch):

        vsig_max_i = max_j (sound_i + sound_j - dv.dr/|dr|) h_i/max(|dr|, h_i)
    """
    dr = box.min_image(r[None, :, :] - r[:, None, :])
    drsqd = jnp.sum(dr * dr, axis=-1)
    drmag = jnp.sqrt(jnp.maximum(drsqd, 1e-300))
    dv = v[None, :, :] - v[:, None, :]
    dvdr = -jnp.sum(dv * dr, axis=-1) / drmag     # part - neib convention
    vsig = sound[:, None] + sound[None, :] - dvdr
    scale = h[:, None] / jnp.maximum(drmag, h[:, None])
    contrib = jnp.where((drsqd > 0) & alive[None, :], vsig * scale, 0.0)
    return jnp.max(contrib, axis=1)
