"""Supernova feedback (reference src/Feedback/Supernova.cpp +
SupernovaDriver.cpp).

A supernova event injects energy Einj (split thermal/kinetic by
R_therm_kin) and mass Minj at a position:

- Minj/mmean NEW hot gas particles are placed randomly inside Rinj,
- existing particles inside Rinj receive a radial kick and heat,
- every affected particle gets vrad = sqrt(2 Einj /(n mmean (R+1)))
  and uinj = Einj /(n mmean (1 + 1/R)).

Static shapes: new particles come from pre-allocated DEAD spare slots
(created at setup, m = 0, FLAG_DEAD) that are activated by the event.
Events are rare host-triggered operations, so the mutation runs host-side
in numpy on a pulled-down state and is pushed back (no recompilation: N
never changes)."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..state import FLAG_DEAD, SphState


@dataclasses.dataclass
class SupernovaEvent:
    t: float
    pos: Tuple[float, ...]
    Einj: float = 0.01
    R_therm_kin: float = 1.0e5
    Minj: float = 0.005
    Rinj: float = 0.0            # 0 -> use h of particle 0 (SedovTestDriver)


@dataclasses.dataclass
class SupernovaDriver:
    """Queued supernovae applied when the simulation time passes each
    event time (SedovTestDriver / SilccSupernovaDriver analogue)."""

    events: List[SupernovaEvent]
    mmean: float
    seed: int = 42
    next_id: int = 0

    @property
    def n_spare_needed(self) -> int:
        return sum(max(int(e.Minj / self.mmean), 0) for e in self.events)

    def pending(self, t: float):
        return (self.events[self.next_id]
                if self.next_id < len(self.events)
                and t >= self.events[self.next_id].t else None)

    def apply(self, state: SphState, ndim: int) -> SphState:
        """Apply the next due event host-side (Supernova::SupernovaInjection,
        Supernova.cpp:53-200)."""
        import jax.numpy as jnp

        ev = self.events[self.next_id]
        self.next_id += 1
        rng = np.random.default_rng(self.seed + self.next_id)

        r = np.asarray(state.r).copy()
        v = np.asarray(state.v).copy()
        m = np.asarray(state.m).copy()
        u = np.asarray(state.u).copy()
        u0 = np.asarray(state.u0).copy()
        flags = np.asarray(state.flags).copy()
        alive = (flags & FLAG_DEAD) == 0

        pos = np.asarray(ev.pos, dtype=r.dtype)
        rinj = ev.Rinj if ev.Rinj > 0 else float(np.asarray(state.h)[0])
        n_new = max(int(ev.Minj / self.mmean), 0)

        # neighbours inside the injection radius
        d = np.sqrt(((r - pos) ** 2).sum(-1))
        neib = alive & (d < rinj)

        # activate spare (dead) slots with random positions in the sphere
        spare = np.where(~alive)[0][:n_new]
        if len(spare):
            phi = 2 * np.pi * rng.random(len(spare))
            costh = 2 * rng.random(len(spare)) - 1 if ndim == 3 else \
                np.zeros(len(spare))
            sinth = np.sqrt(1 - costh ** 2)
            rad = rinj * rng.random(len(spare)) ** (1.0 / ndim)
            unit = np.stack([sinth * np.cos(phi), sinth * np.sin(phi),
                             costh], -1)[:, :ndim]
            r[spare] = pos + rad[:, None] * unit
            m[spare] = self.mmean
            flags[spare] = flags[spare] & ~FLAG_DEAD
            v[spare] = 0.0
            u[spare] = 0.0

        targets = neib.copy()
        targets[spare] = True
        n_tot = max(int(targets.sum()), 1)
        # energy split (Supernova.cpp:116-118)
        vrad = np.sqrt(2.0 / n_tot / self.mmean * ev.Einj
                       / (ev.R_therm_kin + 1.0))
        uinj = ev.Einj / (1.0 + 1.0 / ev.R_therm_kin) / n_tot / self.mmean

        dr = r[targets] - pos
        dmag = np.sqrt((dr ** 2).sum(-1))
        unit = np.where(dmag[:, None] > 0, dr / np.maximum(
            dmag, 1e-30)[:, None], 0.0)
        v[targets] = v[targets] + vrad * unit
        u[targets] = u[targets] + uinj
        u0[targets] = u[targets]

        return state.replace(
            r=jnp.asarray(r), v=jnp.asarray(v), v0=jnp.asarray(v),
            r0=jnp.asarray(r), m=jnp.asarray(m), u=jnp.asarray(u),
            u0=jnp.asarray(u0), flags=jnp.asarray(flags))


def driver_from_params(params, mmean: float):
    """Build the queued-event driver from parameters
    (supernova_feedback = none | sedov_test)."""
    mode = params.stringparams["supernova_feedback"]
    if mode in ("none", "null", ""):
        return None
    if mode == "sedov_test":
        # one SN of E=0.01 at the origin at t = tsupernova
        # (SedovTestDriver, SupernovaDriver.cpp:58-90)
        t_sn = params.floatparams.get("tsupernova", 1.0) \
            if hasattr(params.floatparams, "get") \
            else params.floatparams["tsupernova"]
        ndim = params.intparams["ndim"]
        return SupernovaDriver(
            events=[SupernovaEvent(t=t_sn, pos=(0.0,) * ndim)],
            mmean=mmean, seed=params.intparams["randseed"])
    if mode == "random_sedov":
        # SNe at t = (k + 0.5) tsupernova at uniform-random box positions
        # (RandomSedovTestDriver::Update, SupernovaDriver.cpp).  Event
        # times/positions are pre-drawn for the whole run so the queue
        # stays a static host-side list.
        t_sn = params.floatparams["tsupernova"]
        tend = params.floatparams["tend"]
        ndim = params.intparams["ndim"]
        lo = [params.floatparams[f"boxmin[{k}]"] for k in range(ndim)]
        hi = [params.floatparams[f"boxmax[{k}]"] for k in range(ndim)]
        rng = np.random.default_rng(params.intparams["randseed"])
        n_sn = max(int(tend / t_sn) + 1, 1)
        events = []
        for k in range(n_sn):
            pos = tuple(lo[d] + rng.random() * (hi[d] - lo[d])
                        for d in range(ndim))
            events.append(SupernovaEvent(t=(k + 0.5) * t_sn, pos=pos))
        return SupernovaDriver(events=events, mmean=mmean,
                               seed=params.intparams["randseed"])
    if mode == "silcc":
        # SN event table from SNfile_name: header line, count line, then
        # rows of (t, x, y, z, Einj) (SilccSupernovaDriver,
        # SupernovaDriver.cpp:159-229); Minj/Rinj/R_therm_kin params
        fp = params.floatparams
        fname = params.stringparams["SNfile_name"]
        if not fname:
            raise ValueError("supernova_feedback = silcc needs "
                             "SNfile_name")
        events = []
        with open(fname) as f:
            f.readline()
            n_sn = int(f.readline().split()[0])
            for line in f:
                parts = line.split()
                if len(parts) >= 5:
                    tsn, x, y, z, einj = (float(p) for p in parts[:5])
                    events.append(SupernovaEvent(
                        t=tsn, pos=(x, y, z)[:params.intparams["ndim"]],
                        Einj=einj, R_therm_kin=fp["R_therm_kin"],
                        Minj=fp["Minj"], Rinj=fp["Rinj"]))
                if len(events) >= n_sn:
                    break
        events.sort(key=lambda e: e.t)
        return SupernovaDriver(events=events, mmean=mmean,
                               seed=params.intparams["randseed"])
    raise ValueError(f"unknown supernova_feedback {mode!r}")
