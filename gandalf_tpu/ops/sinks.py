"""Sink particles: creation and accretion (analogue of Sinks,
src/Headers/Sinks.h:57-148 / src/Nbody/Sinks.cpp:118-520).

Vectorised formulation with STATIC shapes:

- sinks live in pre-allocated star slots (Nsinkmax) with an `active` mask
  instead of the reference's dynamic star array,
- creation (Sinks::SearchForNewSinkParticles): at most one new sink per
  step — the densest eligible gas particle (rho > rho_sink, deepest local
  potential) is converted by scatter-activating the next free slot and
  flagging the gas particle dead,
- accretion (Sinks::AccreteMassToSinks, smooth_accretion=0 branch): gas
  particles inside a sink's accretion radius transfer mass and momentum to
  the sink (COM-conserving) and die.

Dead gas particles keep their position but have m = 0 (zero source
contribution everywhere) and are excluded from timestep/diagnostics by the
alive mask.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

Array = jnp.ndarray


class SinkConfig(NamedTuple):
    rho_sink: float
    sink_radius: float      # in units of h (sink_radius_mode = hmult)
    create: bool
    accrete: bool


class SinkState(NamedTuple):
    """Pre-allocated sink/star slots (leapfrog-KDK integrated)."""

    r: Array        # (Ns, ndim)
    v: Array
    a: Array
    r0: Array
    v0: Array
    a0: Array
    m: Array        # (Ns,)
    h: Array        # softening / accretion smoothing scale
    active: Array   # (Ns,) bool
    angmom: Array = None   # (Ns, 3) accreted spin ledger (smooth accretion)
    mdot: Array = None     # (Ns,) accretion rate (reference sink.dmdt,
    #                        src/Nbody/Sinks.cpp:597,609), feeds the
    #                        radiative-feedback sink luminosity


def empty_sinks(n_max: int, ndim: int, dtype) -> SinkState:
    z = jnp.zeros((n_max, ndim), dtype)
    return SinkState(r=z, v=z, a=z, r0=z, v0=z, a0=z,
                     m=jnp.zeros((n_max,), dtype),
                     h=jnp.ones((n_max,), dtype),
                     active=jnp.zeros((n_max,), bool),
                     angmom=jnp.zeros((n_max, 3), dtype),
                     mdot=jnp.zeros((n_max,), dtype))


def make_sinks(r, v, m, h, n_extra: int = 0) -> SinkState:
    """SinkState from star IC arrays + n_extra empty creation slots."""
    import numpy as np

    r = jnp.asarray(np.asarray(r, dtype=np.float64))
    n, ndim = r.shape
    base = empty_sinks(n + n_extra, ndim, r.dtype)
    return base._replace(
        r=base.r.at[:n].set(r), r0=base.r0.at[:n].set(r),
        v=base.v.at[:n].set(jnp.asarray(v, r.dtype)),
        v0=base.v0.at[:n].set(jnp.asarray(v, r.dtype)),
        m=base.m.at[:n].set(jnp.asarray(m, r.dtype)),
        h=base.h.at[:n].set(jnp.asarray(h, r.dtype)),
        active=base.active.at[:n].set(True))


def create_sinks(cfg: SinkConfig, sinks: SinkState,
                 r: Array, v: Array, m: Array, h: Array, rho: Array,
                 gpot: Array, alive: Array) -> Tuple[SinkState, Array]:
    """Convert the densest eligible gas particle into a sink (at most one
    per call, like the reference's per-step search).  Returns the updated
    sinks and the updated gas alive mask."""
    cand, gi = sink_candidate(cfg, r, v, m, h, rho, alive)
    ndim = r.shape[1]
    new_sinks, created = apply_sink_creation(sinks, cand, ndim)
    alive_new = alive.at[gi].set(jnp.where(created, False, alive[gi]))
    return new_sinks, alive_new


def sink_candidate(cfg: SinkConfig, r: Array, v: Array, m: Array,
                   h: Array, rho: Array, alive: Array):
    """Best local sink-creation candidate as a packed row
    [r, v, m, h, score], score = rho of the densest eligible particle
    (-inf when none; the reference searches density/potential minima,
    Sinks.cpp:118).  Shards each compute theirs, gather, and apply the
    global best identically."""
    eligible = alive & (rho > cfg.rho_sink)
    score = jnp.where(eligible, rho, -jnp.inf)
    gi = jnp.argmax(score)
    cand = jnp.concatenate([r[gi], v[gi],
                            jnp.stack([m[gi], h[gi], score[gi]])])
    return cand, gi


def apply_sink_creation(sinks: SinkState, cand: Array,
                        ndim: int) -> Tuple[SinkState, Array]:
    """Activate the next free slot from a packed candidate row.
    Returns (sinks, created bool).  Deterministic given `cand`, so every
    shard applies the identical update when the candidate was chosen
    collectively."""
    score = cand[2 * ndim + 2]
    free = ~sinks.active
    do_create = (score > -jnp.inf) & jnp.any(free)
    slot = jnp.argmax(free)
    put = lambda field, val: field.at[slot].set(
        jnp.where(do_create, val, field[slot]))
    zed = jnp.zeros_like(sinks.a[0])
    r_c, v_c = cand[:ndim], cand[ndim:2 * ndim]
    m_c, h_c = cand[2 * ndim], cand[2 * ndim + 1]
    new_sinks = sinks._replace(
        r=put(sinks.r, r_c), r0=put(sinks.r0, r_c),
        v=put(sinks.v, v_c), v0=put(sinks.v0, v_c),
        a=put(sinks.a, zed), a0=put(sinks.a0, zed),
        m=put(sinks.m, m_c), h=put(sinks.h, h_c),
        active=sinks.active.at[slot].set(
            jnp.where(do_create, True, sinks.active[slot])))
    return new_sinks, do_create


def accretion_sums(cfg: SinkConfig, sinks: SinkState,
                   r: Array, v: Array, m: Array, alive: Array):
    """Per-sink accretion sums (dm, dmom, dmr) over the LOCAL gas plus the
    local eaten mask.  Each gas particle is claimed by its NEAREST
    accreting sink.  In distributed mode the sums are psum'd across shards
    before apply_accretion (reference MpiControl::UpdateSinksAfterAccretion
    src/Mpi/MpiControl.cpp:408-431)."""
    Ns = sinks.m.shape[0]
    dr = r[:, None, :] - sinks.r[None, :, :]          # (N, Ns, nd)
    dist = jnp.sqrt(jnp.sum(dr * dr, axis=-1))
    racc = cfg.sink_radius * sinks.h
    inside = (dist < racc[None, :]) & sinks.active[None, :]
    dist_masked = jnp.where(inside, dist, jnp.inf)
    nearest = jnp.argmin(dist_masked, axis=1)         # (N,)
    eaten = alive & jnp.any(inside, axis=1)

    w = jnp.where(eaten, m, 0.0)
    dm = jnp.zeros((Ns,), m.dtype).at[nearest].add(w)
    dmom = jnp.zeros_like(sinks.v).at[nearest].add(w[:, None] * v)
    dmr = jnp.zeros_like(sinks.r).at[nearest].add(w[:, None] * r)
    return dm, dmom, dmr, eaten


def apply_accretion(sinks: SinkState, dm: Array, dmom: Array,
                    dmr: Array) -> SinkState:
    """COM-conserving sink update from (possibly psum'd) accretion sums."""
    m_new = sinks.m + dm
    msafe = jnp.maximum(m_new, 1e-300)
    v_new = (sinks.m[:, None] * sinks.v + dmom) / msafe[:, None]
    r_new = (sinks.m[:, None] * sinks.r + dmr) / msafe[:, None]
    upd = sinks.active & (dm > 0)
    return sinks._replace(
        r=jnp.where(upd[:, None], r_new, sinks.r),
        v=jnp.where(upd[:, None], v_new, sinks.v),
        r0=jnp.where(upd[:, None], r_new, sinks.r0),
        v0=jnp.where(upd[:, None], v_new, sinks.v0),
        m=jnp.where(upd, m_new, sinks.m))


def accrete_to_sinks(cfg: SinkConfig, sinks: SinkState,
                     r: Array, v: Array, m: Array, alive: Array
                     ) -> Tuple[SinkState, Array]:
    """Accrete gas inside each sink's accretion radius
    (radius = sink_radius * h_sink); mass/momentum conserving."""
    dm, dmom, dmr, eaten = accretion_sums(cfg, sinks, r, v, m, alive)
    return apply_accretion(sinks, dm, dmom, dmr), alive & ~eaten


def smooth_accretion_sums(cfg: SinkConfig, sinks: SinkState,
                          r: Array, v: Array, m: Array, rho: Array,
                          sound: Array, u: Array, alive: Array,
                          dt: Array, kern, mmean: float,
                          alpha_ss: float = 0.01,
                          smooth_accrete_frac: float = 0.01,
                          smooth_accrete_dt: float = 0.01):
    """SMOOTH accretion sums (Sinks::AccreteMassToSinks smooth_accretion=1
    branch, src/Nbody/Sinks.cpp:520-720): the per-step accreted mass
    follows menc (1 - exp(-dt/taccrete)) with taccrete interpolating the
    radial-drift and Shakura-Sunyaev viscous timescales by the rotational
    energy fraction; mass is removed FRACTIONALLY from the contained gas.

    Deviations from the reference (documented): the accreted mass is distributed
    over the contained particles proportionally to their kernel weight
    (the reference subtracts greedily in neighbour-list order — an
    order-dependent serial loop), and the gpe sum uses the mean enclosed
    mass rather than the reference's running partial sum.

    Returns (dm_gas (N,) mass removed per particle, sums dict per sink)."""
    Ns = sinks.m.shape[0]
    ndim = r.shape[1]
    drv = r[:, None, :] - sinks.r[None, :, :]        # (N, Ns, nd)
    dist = jnp.sqrt(jnp.sum(drv * drv, axis=-1)) + 1e-30
    racc = cfg.sink_radius * sinks.h
    inside = (dist < racc[None, :]) & sinks.active[None, :] \
        & alive[:, None]
    dist_masked = jnp.where(inside, dist, jnp.inf)
    nearest = jnp.argmin(dist_masked, axis=1)
    claim = inside & (jnp.arange(Ns)[None, :] == nearest[:, None])

    m_in = jnp.where(claim, m[:, None], 0.0)         # (N, Ns)
    menc = jnp.sum(m_in, axis=0)
    invh = 1.0 / jnp.maximum(sinks.h, 1e-30)
    w0 = kern.w0_s2((dist * invh[None, :]) ** 2) * (invh ** ndim)[None, :]
    w0 = jnp.where(claim, w0, 0.0)
    w_rho = w0 / jnp.maximum(rho, 1e-30)[:, None]
    wnorm = jnp.sum(m_in * w_rho, axis=0)

    # energies (kernel-weighted; Sinks.cpp:545-575)
    unit = drv / dist[..., None]
    dv = v[:, None, :] - sinks.v[None, :, :]
    dvdr = jnp.sum(dv * unit, axis=-1)
    dvtang2 = jnp.sum(dv * dv, axis=-1) - dvdr * dvdr
    gpetot = jnp.sum(jnp.where(claim, 0.5 * m[:, None]
                               * (sinks.m + 0.5 * menc)[None, :]
                               * invh[None, :]
                               * kern.wpot(dist * invh[None, :]), 0.0), 0)
    norm = 0.5 * menc / jnp.maximum(wnorm, 1e-30)
    ketot = norm * jnp.sum(m_in * jnp.sum(dv * dv, -1) * w_rho, axis=0)
    rotketot = norm * jnp.sum(m_in * dvtang2 * w_rho, axis=0)

    # timescales (Sinks.cpp:565-596)
    log_tv = jnp.sum(jnp.where(
        claim, m[:, None] * jnp.log(jnp.maximum(
            jnp.sqrt(dist) / jnp.maximum(sound, 1e-30)[:, None] ** 2,
            1e-30)), 0.0), axis=0)
    tvisc = jnp.sqrt(sinks.m + menc) \
        * jnp.exp(log_tv / jnp.maximum(menc, 1e-30)) / alpha_ss
    trad_sum = jnp.sum(jnp.where(
        claim, jnp.abs(4.0 * jnp.pi * dist * dist * m[:, None]
                       * dvdr * w0), 0.0), axis=0)
    trad = menc / jnp.maximum(trad_sum, 1e-30)
    trot = 2.0 * jnp.pi * jnp.sqrt(
        racc ** 3 / jnp.maximum(menc + sinks.m, 1e-30))

    efrac = jnp.clip(2.0 * rotketot / jnp.maximum(gpetot, 1e-30),
                     0.0, 1.0)
    taccrete = jnp.maximum(trad, 1e-30) ** (1.0 - efrac) \
        * jnp.maximum(tvisc, 1e-30) ** efrac
    macc = menc * jnp.maximum(
        1.0 - jnp.exp(-dt / jnp.maximum(taccrete, 1e-30)), 0.0)

    # distribute macc over contained gas by kernel weight
    wsum = jnp.maximum(jnp.sum(m_in * w_rho, axis=0), 1e-30)
    frac = (m_in * w_rho) / wsum[None, :]
    dm = jnp.minimum(jnp.sum(frac * macc[None, :], axis=1), m)
    # full accretion for nearly-empty particles or fast orbits
    trot_p = trot[nearest]
    dt_part = dt
    full = (m - dm < smooth_accrete_frac * mmean) \
        | (dt_part < smooth_accrete_dt * trot_p)
    full = full & claim.any(axis=1)
    dm = jnp.where(full, m, dm)
    return dm, {"claim": claim, "menc": menc, "macc": macc,
                "taccrete": taccrete, "dmdt": macc
                / jnp.maximum(dt, 1e-30)}


def apply_smooth_accretion(sinks: SinkState, r: Array, v: Array,
                           m: Array, dm: Array, claim: Array,
                           alive: Array):
    """COM + ANGULAR-MOMENTUM conserving sink update from fractional
    accretion (Sinks.cpp:615-720): the sink gains the accreted mass and
    momentum; the spin ledger collects the angular momentum of the old
    COM and of each accreted parcel about the new COM.  Returns
    (sinks, m_new, alive_new)."""
    dm_s = jnp.where(claim, dm[:, None], 0.0)        # (N, Ns)
    dmtot = jnp.sum(dm_s, axis=0)
    m_new_sink = sinks.m + dmtot
    msafe = jnp.maximum(m_new_sink, 1e-300)
    r_new = (sinks.m[:, None] * sinks.r
             + jnp.einsum("ns,ni->si", dm_s, r)) / msafe[:, None]
    v_new = (sinks.m[:, None] * sinks.v
             + jnp.einsum("ns,ni->si", dm_s, v)) / msafe[:, None]

    def cross(a, b):
        if a.shape[-1] == 3:
            return jnp.cross(a, b)
        z = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
        return jnp.stack([jnp.zeros_like(z), jnp.zeros_like(z), z], -1)

    # spin: old COM about new COM + accreted parcels about new COM
    dL_old = sinks.m[:, None] * cross(sinks.r - r_new, sinks.v - v_new)
    dr_p = r[:, None, :] - r_new[None, :, :]
    dv_p = v[:, None, :] - v_new[None, :, :]
    dL_gas = jnp.einsum("ns,nsk->sk", dm_s, cross(dr_p, dv_p))
    upd = sinks.active & (dmtot > 0)
    angmom = sinks.angmom + jnp.where(upd[:, None], dL_old + dL_gas, 0.0)
    new_sinks = sinks._replace(
        r=jnp.where(upd[:, None], r_new, sinks.r),
        v=jnp.where(upd[:, None], v_new, sinks.v),
        r0=jnp.where(upd[:, None], r_new, sinks.r0),
        v0=jnp.where(upd[:, None], v_new, sinks.v0),
        m=jnp.where(upd, m_new_sink, sinks.m),
        angmom=angmom)
    m_gas = m - dm
    alive_new = alive & (m_gas > 0.0)
    return new_sinks, m_gas, alive_new
