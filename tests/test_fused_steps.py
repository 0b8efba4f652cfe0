"""Async-burst stepping (SimulationBase.main_loop_steps): several
global-dt steps dispatched without intermediate host syncs must be
bit-identical to the same number of per-step main_loop_step calls, stay
clear of the snapshot/tend time bounds, and respect the tree-rebuild
cadence.

The burst path exists for throughput (the per-step loop syncs with the
device after every step), so its contract is exact equivalence with the
per-step loop it replaces: bursts are async dispatches of the SAME
program the per-step path runs.
"""

import numpy as np
import pytest

from gandalf_tpu.params import Parameters
from gandalf_tpu.sim.simulation import GradhSphSimulation


def _box_sim(n_side=6, self_gravity=1, tend=1.0e30, tsnapfirst=1.0e30):
    p = Parameters()
    updates = {
        "run_id": "", "sim": "gradhsph", "ic": "box", "ndim": 3,
        "dimensionless": 1, "gas_eos": "energy_eqn", "gamma_eos": 1.4,
        "rhofluid1": 1.0, "press1": 1.0, "tend": tend,
        "tsnapfirst": tsnapfirst, "self_gravity": self_gravity,
        "ewald": 0, "ntreebuildstep": 8,
    }
    for k in range(3):
        updates[f"boxmin[{k}]"] = 0.0
        updates[f"boxmax[{k}]"] = 1.0
        updates[f"boundary_lhs[{k}]"] = "periodic"
        updates[f"boundary_rhs[{k}]"] = "periodic"
        updates[f"Nlattice1[{k}]"] = n_side
    for k, v in updates.items():
        p.set(k, v)
    sim = GradhSphSimulation(p)
    sim.SetupSimulation()
    # jitter the velocities so steps do non-trivial work
    rng = np.random.default_rng(7)
    import jax.numpy as jnp

    v = 0.05 * rng.standard_normal(np.asarray(sim.state.v).shape)
    sim.state = sim.state.replace(v=jnp.asarray(v, sim.state.v.dtype),
                                  v0=jnp.asarray(v, sim.state.v.dtype))
    return sim


def test_burst_matches_per_step():
    simA = _box_sim()
    simB = _box_sim()
    assert simB._can_burst, "flagship config must enable burst stepping"
    NS = 12  # crosses one ntreebuildstep=8 rebuild boundary
    for _ in range(NS):
        simA.main_loop_step()
    done = 0
    windows = []
    while done < NS:
        k = simB.main_loop_steps(NS - done)
        windows.append(k)
        done += k
    assert done == NS
    # the path must actually BURST (a silent per-step fallback passes the
    # parity assertions trivially — that bug shipped once)
    assert max(windows) > 1, f"no window burst: {windows}"
    assert simB.Nsteps == simA.Nsteps
    assert simB.t == simA.t
    for f in ("r", "v", "rho", "u", "h", "a", "dt"):
        a = np.asarray(getattr(simA.state, f))
        b = np.asarray(getattr(simB.state, f))
        assert np.array_equal(a, b), f"{f} diverged"
    # the burst is clipped at the rebuild cadence, so a single call must
    # never run past the next boundary — and must burst right up to it
    simC = _box_sim()
    n = simC.main_loop_steps(100)
    assert n == 8


def test_burst_stays_clear_of_tsnapnext():
    """The burst must not cross the next-snapshot time: it stops short
    (conservative dt estimate) and the per-step path lands the crossing
    with exact snapshot-at-first-step-past-the-mark semantics."""
    sim = _box_sim()
    sim.main_loop_step()
    dt = float(sim.state.dt)
    t0 = sim.t
    sim.tsnapnext = t0 + 12.5 * dt
    n = sim.main_loop_steps(8)
    assert n > 1, "expected a burst while far from the mark"
    assert sim.t < sim.tsnapnext, "burst crossed the snapshot mark"
    # approach the mark: calls shrink to per-step and cross exactly once
    while sim.t < sim.tsnapnext:
        k = sim.main_loop_steps(8)
    assert sim.t >= sim.tsnapnext
    assert sim.t - sim.tsnapnext < 2.5 * dt


def test_burst_mfv_matches_per_step():
    """The MFV controller shares the burst machinery."""
    from gandalf_tpu.sim.mfv_sim import MfvMusclSimulation

    def mk():
        p = Parameters()
        updates = {
            "run_id": "", "sim": "mfvmuscl", "ic": "box", "ndim": 3,
            "dimensionless": 1, "gas_eos": "energy_eqn",
            "gamma_eos": 1.4, "rhofluid1": 1.0, "press1": 1.0,
            "tend": 1.0e30, "tsnapfirst": 1.0e30, "riemann_solver": "hllc",
        }
        for k in range(3):
            updates[f"boxmin[{k}]"] = 0.0
            updates[f"boxmax[{k}]"] = 1.0
            updates[f"boundary_lhs[{k}]"] = "periodic"
            updates[f"boundary_rhs[{k}]"] = "periodic"
            updates[f"Nlattice1[{k}]"] = 6
        for k, v in updates.items():
            p.set(k, v)
        sim = MfvMusclSimulation(p)
        sim.SetupSimulation()
        import jax.numpy as jnp

        rng = np.random.default_rng(7)
        v = 0.05 * rng.standard_normal(np.asarray(sim.state.v).shape)
        sim.state = sim.state.replace(v=jnp.asarray(v, sim.state.v.dtype),
                                      v0=jnp.asarray(v, sim.state.v.dtype))
        return sim

    simA, simB = mk(), mk()
    assert simB._can_burst
    NS = 6
    for _ in range(NS):
        simA.main_loop_step()
    done, windows = 0, []
    while done < NS:
        k = simB.main_loop_steps(NS - done)
        windows.append(k)
        done += k
    assert max(windows) > 1, f"no MFV window burst: {windows}"
    assert simB.t == simA.t
    for f in ("r", "v", "rho", "u", "h"):
        assert np.array_equal(np.asarray(getattr(simA.state, f)),
                              np.asarray(getattr(simB.state, f))), f


def test_burst_respects_tend():
    """tend is never overshot: the burst stays clear of the bound and
    the per-step fallback lands the dt-clamped final step exactly."""
    sim = _box_sim()
    sim.main_loop_step()
    dt = float(sim.state.dt)
    tend = sim.t + 3.4 * dt
    sim.params.set("tend", tend)
    for _ in range(12):
        if sim.t >= tend:
            break
        sim.main_loop_steps(6)
    assert sim.t == pytest.approx(tend, rel=1e-12)
