"""Hierarchical (block) timesteps — power-of-two per-particle levels.

Vectorised formulation of Simulation::ComputeBlockTimesteps
(src/Common/Simulation.cpp:1763-2197), SphLeapfrogKDK::AdvanceParticles /
EndTimestep / CheckTimesteps (src/Hydrodynamics/SphLeapfrogKDK.cpp:77-329).

The reference walks particle arrays with per-particle branches; here every
branch becomes a masked dense update so one jitted tick handles the whole
population:

- integer tick counter `n`, base tick `dt_base = dt_max / nresync`,
- per-particle level, nstep = 2^(level_step - level), nlast, tlast,
- all particles DRIFT every tick (positions/velocities predicted from the
  start of their own step); only particles with dn == nstep are "active"
  and receive the end-of-step correction kick + a new timestep level,
- Saitoh & Makino (2009) neighbour limiter: an inactive particle whose
  neighbours sit more than `level_diff_max` levels above it finishes its
  step prematurely (CheckTimesteps),
- resynchronisation at n == nresync rebuilds the ladder from fresh
  timesteps; level_max growth/shrink between resyncs rescales n / nlast /
  nstep by powers of two exactly as the reference does.

integration_step = 1 (leapfrog KDK), so level_step == level_max.
`hydro_single_timestep` is not implemented (all particles on level_max
would reduce to the global scheme).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
from jax import lax

from ..state import SphState

Array = jnp.ndarray

LEVEL_CAP = 20          # ladder depth guard (nresync <= 2^20 ticks, int32-safe)


class BlockSchedule(NamedTuple):
    """Dynamic block-timestep bookkeeping carried across ticks."""

    n: Array            # () int32  integer time inside the resync interval
    level_max: Array    # () int32  deepest occupied level (== level_step)
    nresync: Array      # () int32  2^level_step
    dt_base: Array      # () float  one tick of simulation time
    dt_max: Array       # () float  level-0 step (fixed between resyncs)
    nstep_part: Array   # (N,) int32  per-particle integer step size
    dt_next: Array      # (N,) float  most recent timestep criterion


class BlockConfig(NamedTuple):
    nlevels: int
    level_diff_max: int


def compute_timestep_level(dt: Array, dt_max: Array) -> Array:
    """ComputeTimestepLevel (src/Headers/InlineFuncs.h:550-558): C-style
    truncation toward zero of log2(dt_max/dt), plus one, floored at 0."""
    ratio = dt_max / jnp.maximum(dt, 1e-30)
    lvl = (jnp.log(jnp.maximum(ratio, 1e-30))
           * 1.4426950408889634).astype(jnp.int32) + 1
    return jnp.clip(lvl, 0, LEVEL_CAP)


def _pow2(e: Array) -> Array:
    return jnp.left_shift(jnp.int32(1), jnp.clip(e, 0, 30))


def init_schedule(cfg: BlockConfig, s: SphState, dt_part: Array,
                  dt_extra: Array = None, axis_name: str = None
                  ) -> Tuple[SphState, BlockSchedule]:
    """Build the initial ladder (the n == nresync resync branch at n = 0;
    Simulation.cpp:1795-1927).  `dt_extra` is an optional scalar timestep
    bound from non-gas integrators (sinks/stars: the reference folds
    N-body dt into the same ladder, Simulation.cpp:1860-1873) — it deepens
    the ladder so dt_base stays below it.  `axis_name` makes the scalar
    ladder reductions collective for a shard_map caller (the reference's
    dt MPI_Allreduce, Simulation.cpp:1736-1747)."""
    alive = s.alive
    big = jnp.asarray(1e30, dt_part.dtype)
    dtp = jnp.where(alive, dt_part, big)
    dt_min = jnp.min(dtp)
    if axis_name is not None:
        dt_min = lax.pmin(dt_min, axis_name)
    if dt_extra is not None:
        dt_min = jnp.minimum(dt_min, dt_extra)
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
                  tlast=jnp.broadcast_to(s.t, s.m.shape).astype(s.m.dtype))
    return s, sched


def advance(s: SphState, B: BlockSchedule, u_mode
            ) -> Tuple[SphState, Array, Array]:
    """One tick of drift for ALL particles (AdvanceParticles,
    SphLeapfrogKDK.cpp:96-123).  Returns (state, active mask, new t).

    u_mode: "none" | "energy" (explicit du/dt forward integration) |
    "radws" (exponential relaxation toward radiative equilibrium,
    EnergyRadws::EnergyIntegration, EnergyRadws.cpp:107-130)."""
    if isinstance(u_mode, bool):        # legacy bool: energy on/off
        u_mode = "energy" if u_mode else "none"
    n = B.n + 1
    t = s.t + B.dt_base
    dtp = (t - s.tlast)[:, None]
    r = s.r0 + s.v0 * dtp + 0.5 * s.a0 * dtp * dtp
    v = s.v0 + s.a0 * dtp
    out = {"r": r, "v": v}
    if u_mode == "energy":
        out["u"] = s.u0 + s.dudt0 * dtp[:, 0]
    elif u_mode == "radws":
        from ..ops.radws import radws_energy_integration

        out["u"] = radws_energy_integration(s.u0, s.ueq, s.dt_therm,
                                            dtp[:, 0])
    active = ((n - s.nlast) == B.nstep_part) & s.alive
    return s.replace(**out), active, t


def check_timesteps(cfg: BlockConfig, s: SphState, B: BlockSchedule,
                    active: Array) -> Tuple[Array, Array, Array]:
    """Saitoh & Makino neighbour limiter (SphLeapfrogKDK::CheckTimesteps,
    SphLeapfrogKDK.cpp:284-329): prematurely end the step of particles
    whose neighbours are > level_diff_max levels above, when the truncated
    step stays level-synchronised.

    Returns (active', nstep_part', level')."""
    n = B.n + 1
    dn = n - s.nlast
    level_new = s.levelneib - cfg.level_diff_max
    nnewstep = _pow2(B.level_max - jnp.minimum(level_new, B.level_max))
    reduce_ = (~active) & s.alive \
        & ((s.levelneib - s.level) > cfg.level_diff_max) \
        & ((dn % nnewstep) == 0)
    nstep = jnp.where(reduce_ & (dn > 0), dn, B.nstep_part)
    level = jnp.where(reduce_, level_new, s.level)
    return active | reduce_, nstep, level


def end_timestep(cfg: BlockConfig, s: SphState, B: BlockSchedule,
                 active: Array, level: Array, nstep_part: Array,
                 dt_crit: Array, t: Array, u_mode,
                 dt_extra: Array = None, axis_name: str = None
                 ) -> Tuple[SphState, BlockSchedule]:
    """Correction kick + level/ladder update for particles ending their
    step (EndTimestep SphLeapfrogKDK.cpp:227-271 + ComputeBlockTimesteps
    Simulation.cpp:1795-2160).  `level`/`nstep_part` carry any Saitoh-
    Makino reductions; `dt_crit` is the freshly evaluated per-particle
    timestep criterion (used only where active).  `dt_extra` is an
    optional scalar non-gas (sink/star) timestep bound: it deepens the
    ladder at resync AND can grow level_max mid-interval, mirroring the
    reference forcing N-body levels >= hydro levels
    (Simulation.cpp:1860-1873).  `axis_name` makes the scalar ladder
    reductions (dt_min / level_max occupancy) collective for a shard_map
    caller so every shard agrees on the schedule."""
    if isinstance(u_mode, bool):
        u_mode = "energy" if u_mode else "none"
    n = B.n + 1
    alive = s.alive
    dt_p = jnp.where(active, t - s.tlast, 0.0)

    # ---- end-of-step kick (KDK correction) --------------------------------
    v = jnp.where(active[:, None], s.v + 0.5 * dt_p[:, None] * (s.a - s.a0),
                  s.v)
    upd = {"v": v,
           "r0": jnp.where(active[:, None], s.r, s.r0),
           "v0": jnp.where(active[:, None], v, s.v0),
           "a0": jnp.where(active[:, None], s.a, s.a0)}
    if u_mode == "energy":
        u = s.u + 0.5 * (s.dudt - s.dudt0) * dt_p
        u = jnp.where(u <= 0.0, s.u0 + s.dudt0 * dt_p, u)
        u = jnp.where(active, u, s.u)
        upd["u"] = u
        upd["u0"] = jnp.where(active, u, s.u0)
        upd["dudt0"] = jnp.where(active, s.dudt, s.dudt0)
    elif u_mode == "radws":
        # relaxation already wrote u in advance(); freeze the new start
        # point (EnergyRadws::EndTimestep, EnergyRadws.cpp:153-190)
        upd["u0"] = jnp.where(active, s.u, s.u0)
        upd["dudt0"] = jnp.where(active, s.dudt, s.dudt0)

    dt_next = jnp.where(active, dt_crit, B.dt_next)
    lad, B = ladder_update(cfg, B, alive, active, level, s.levelneib,
                           nstep_part, s.nlast, s.tlast, dt_next, n, t,
                           dt_extra=dt_extra, axis_name=axis_name)
    s = s.replace(t=t, dt=B.dt_base, **lad, **upd)
    return s, B


def ladder_update(cfg: BlockConfig, B: BlockSchedule, alive: Array,
                  active: Array, level: Array, levelneib: Array,
                  nstep_part: Array, nlast: Array, tlast: Array,
                  dt_next: Array, n: Array, t: Array,
                  dt_extra: Array = None, axis_name: str = None):
    """The scheme-independent part of ComputeBlockTimesteps
    (Simulation.cpp:1795-2160): per-particle level moves, level_max
    growth/shrink with integer-time rescaling, and the resync rebuild.
    Shared by the leapfrog-KDK (SPH) and MFV block integrators.

    Returns (dict(level=, levelneib=, nlast=, tlast=), BlockSchedule)."""
    is_resync = n == B.nresync

    # ---- resync branch (n == nresync): rebuild the ladder ------------------
    big = jnp.asarray(1e30, dt_next.dtype)
    dtp_sync = jnp.where(alive, dt_next, big)
    dt_min = jnp.min(dtp_sync)
    if axis_name is not None:
        dt_min = lax.pmin(dt_min, axis_name)
    if dt_extra is not None:
        dt_min = jnp.minimum(dt_min, dt_extra)
    lmax_sync = jnp.asarray(cfg.nlevels - 1, jnp.int32)
    dtmax_sync = dt_min * _pow2(lmax_sync).astype(dt_min.dtype)
    lvl_sync = jnp.minimum(compute_timestep_level(dtp_sync, dtmax_sync),
                           lmax_sync)
    lvl_sync = jnp.where(alive, lvl_sync, lmax_sync)

    # ---- adjust branch: per-particle level moves --------------------------
    lvl_req = jnp.maximum(compute_timestep_level(dt_next, B.dt_max),
                          levelneib - cfg.level_diff_max)
    natural = active & (nstep_part == _pow2(B.level_max - level))
    # natural end: down one level only at a synchronised boundary
    down_ok = (lvl_req < level) & (level > 1) \
        & ((n % (2 * nstep_part)) == 0)
    lvl_nat = jnp.where(down_ok, level - 1,
                        jnp.where(lvl_req > level, lvl_req, level))
    # artificially shortened step (Saitoh-Makino last tick): only raise
    lvl_art = jnp.maximum(level, lvl_req)
    lvl_adj = jnp.where(active, jnp.where(natural, lvl_nat, lvl_art), level)
    lvl_adj = jnp.clip(lvl_adj, 0, LEVEL_CAP)
    neib_adj = jnp.where(active, jnp.where(natural, lvl_req, lvl_adj),
                         levelneib)

    # level_max bookkeeping + integer-time rescaling (Simulation.cpp:2098-2135)
    lmax_old = B.level_max
    lmax_occ = jnp.max(jnp.where(alive, lvl_adj, 0))
    if axis_name is not None:
        lmax_occ = lax.pmax(lmax_occ, axis_name)
    if dt_extra is not None:
        # sinks/stars always step at dt_base: deepen the ladder so
        # dt_base <= dt_extra (clip to +1 level per tick to avoid an
        # unbounded integer-time rescale from a transient spike)
        lvl_extra = jnp.minimum(compute_timestep_level(dt_extra, B.dt_max),
                                lmax_old + 1)
        lmax_occ = jnp.maximum(lmax_occ, lvl_extra)
    grow = lmax_occ > lmax_old
    istep = _pow2(lmax_old - lmax_old + 1)      # 2: one-level-up boundary
    shrink = (~grow) & (lmax_occ <= lmax_old - 1) & (lmax_old > 1) \
        & ((n % istep) == 0)
    nf_g = _pow2(lmax_occ - lmax_old)
    lmax_adj = jnp.where(grow, lmax_occ,
                         jnp.where(shrink, lmax_old - 1, lmax_old))
    nfac = jnp.where(grow, nf_g, jnp.asarray(1, jnp.int32))
    ndiv = jnp.where(shrink, jnp.asarray(2, jnp.int32),
                     jnp.asarray(1, jnp.int32))
    n_adj = (n * nfac) // ndiv
    nlast_all = (nlast * nfac) // ndiv
    nstep_all = (nstep_part * nfac) // ndiv

    nresync_adj = _pow2(lmax_adj)
    dtbase_adj = B.dt_max / nresync_adj.astype(B.dt_max.dtype)
    # particles ending now get nstep for their (possibly new) level
    nstep_adj = jnp.where(active, _pow2(lmax_adj - lvl_adj), nstep_all)
    nlast_adj = jnp.where(active, n_adj, nlast_all)

    # ---- select branch -----------------------------------------------------
    sel = lambda a, b: jnp.where(is_resync, a, b)
    level_out = sel(lvl_sync, lvl_adj)
    levelneib_out = sel(lvl_sync, neib_adj)
    lmax_out = sel(lmax_sync, lmax_adj)
    n_out = sel(jnp.asarray(0, jnp.int32), n_adj)
    nresync_out = sel(_pow2(lmax_sync), nresync_adj)
    dtmax_out = sel(dtmax_sync, B.dt_max)
    dtbase_out = sel(dtmax_sync / _pow2(lmax_sync).astype(dt_min.dtype),
                     dtbase_adj)
    nstep_out = sel(_pow2(lmax_sync - lvl_sync), nstep_adj)
    nlast_out = sel(jnp.zeros_like(nlast), nlast_adj)
    tlast_out = jnp.where(active | is_resync, t, tlast)

    lad = dict(level=level_out, levelneib=levelneib_out,
               nlast=nlast_out, tlast=tlast_out)
    B = BlockSchedule(n=n_out, level_max=lmax_out, nresync=nresync_out,
                      dt_base=dtbase_out, dt_max=dtmax_out,
                      nstep_part=nstep_out, dt_next=dt_next)
    return lad, B


def compute_levelneib(box, r: Array, h: Array, level: Array,
                      kernrange: float, alive: Array) -> Array:
    """max neighbour level within kernel range (either direction), the
    quantity the reference accumulates inside its force loops
    (e.g. GradhSph.cpp:461 levelneib updates)."""
    dr = box.min_image(r[None, :, :] - r[:, None, :])
    drsqd = jnp.sum(dr * dr, axis=-1)
    hmax = jnp.maximum(h[:, None], h[None, :])
    near = drsqd <= (kernrange * hmax) ** 2
    near = near & alive[None, :]
    lvl = jnp.where(near, level[None, :], 0)
    return jnp.max(lvl, axis=1)
