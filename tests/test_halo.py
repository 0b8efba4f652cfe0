"""Multi-device halo-exchange pipeline (parallel/halo.py) — the analogue
of the reference's MPI domain decomposition + ghost exchange (SURVEY §2.6).
Runs on the virtual CPU device mesh from conftest."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from gandalf_tpu.ops.sph_grid27 import hydro_pass_grid27, plan_grid27
from gandalf_tpu.parallel.halo import hydro_pass_grid27_sharded
from gandalf_tpu.params import Parameters
from gandalf_tpu.sim.ic import generate_ic
from gandalf_tpu.sim.simulation import GradhSphSimulation
from gandalf_tpu.state import make_sph_state


def _setup(periodic=True, n_side=16, seed=3):
    p = Parameters()
    for k, v in {"ndim": 3, "sim": "sph", "ic": "box", "dimensionless": 1,
                 "run_id": "", "gas_eos": "energy_eqn", "gamma_eos": 1.4,
                 "rhofluid1": 1.0, "press1": 1.0,
                 "neib_search": "kdtree"}.items():
        p.set(k, v)
    btype = "periodic" if periodic else "open"
    for k in range(3):
        p.set(f"Nlattice1[{k}]", n_side)
        p.set(f"boxmin[{k}]", 0.0)
        p.set(f"boxmax[{k}]", 1.0)
        p.set(f"boundary_lhs[{k}]", btype)
        p.set(f"boundary_rhs[{k}]", btype)
    sim = GradhSphSimulation(p)
    sim.process_parameters()
    ic = generate_ic(sim.params, sim.eos)
    rng = np.random.default_rng(seed)
    ic["r"] = np.mod(ic["r"] + 0.02 * rng.standard_normal(ic["r"].shape),
                     1.0)
    ic["v"] = 0.1 * rng.standard_normal(ic["v"].shape)
    s = make_sph_state(ic["r"], ic["v"], ic["m"], ic["h"], ic["u"])
    h_max = float(np.asarray(ic["h"]).max()) * 1.3
    return sim, s, ic, h_max


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_matches_single_device_periodic(ndev):
    sim, s, ic, h_max = _setup(periodic=True)
    spec = plan_grid27(sim.box, ic["r"], h_max, sim.kern.kernrange,
                       z_multiple=ndev)
    assert spec.ncells[0] % ndev == 0
    ref = hydro_pass_grid27(sim.kern, sim.visc, sim.box, spec, sim.eos,
                            sim.h_fac, sim.h_converge, True, s)
    mesh = Mesh(np.array(jax.devices()[:ndev]), axis_names=("dp",))
    shd = hydro_pass_grid27_sharded(mesh, "dp", sim.kern, sim.visc,
                                    sim.box, spec, sim.eos, sim.h_fac,
                                    sim.h_converge, True, s)
    for f in ("rho", "h", "a", "dudt", "div_v", "pressure", "invomega"):
        a = np.asarray(getattr(ref, f))
        b = np.asarray(getattr(shd, f))
        assert np.abs(a - b).max() < 1e-12, f
    assert bool(shd.neib_overflow) == bool(ref.neib_overflow)


def test_sharded_matches_single_device_open_boundaries():
    sim, s, ic, h_max = _setup(periodic=False)
    spec = plan_grid27(sim.box, ic["r"], h_max, sim.kern.kernrange,
                       z_multiple=4)
    ref = hydro_pass_grid27(sim.kern, sim.visc, sim.box, spec, sim.eos,
                            sim.h_fac, sim.h_converge, True, s)
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("dp",))
    shd = hydro_pass_grid27_sharded(mesh, "dp", sim.kern, sim.visc,
                                    sim.box, spec, sim.eos, sim.h_fac,
                                    sim.h_converge, True, s)
    for f in ("rho", "a", "dudt"):
        a = np.asarray(getattr(ref, f))
        b = np.asarray(getattr(shd, f))
        assert np.abs(a - b).max() < 1e-12, f
