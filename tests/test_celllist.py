"""Cell-list neighbour search vs the all-pairs brute-force oracle
(the analogue of the reference's bruteforce-tree validation,
src/Tree/BruteForceTree.cpp usage in tests/paper_tests/treescaling.py)."""

import numpy as np
import pytest

from gandalf_tpu.params import Parameters
from gandalf_tpu.sim.simulation import GradhSphSimulation
from gandalf_tpu.state import make_sph_state


def make_box_params(n_side=10, ndim=3, neib="kdtree"):
    p = Parameters()
    updates = {
        "run_id": "CLTEST", "sim": "gradhsph", "ic": "box", "ndim": ndim,
        "dimensionless": 1, "gas_eos": "energy_eqn", "gamma_eos": 1.4,
        "rhofluid1": 1.0, "press1": 1.0, "tend": 1.0e30,
        "tsnapfirst": 1.0e30, "neib_search": neib,
    }
    for k in range(ndim):
        updates[f"boxmin[{k}]"] = 0.0
        updates[f"boxmax[{k}]"] = 1.0
        updates[f"boundary_lhs[{k}]"] = "periodic"
        updates[f"boundary_rhs[{k}]"] = "periodic"
        updates[f"Nlattice1[{k}]"] = n_side
    for k, v in updates.items():
        p.set(k, v)
    return p


def jittered_state(sim, seed=3, jitter=0.2):
    from gandalf_tpu.sim.ic import generate_ic

    ic = generate_ic(sim.params, sim.eos)
    rng = np.random.default_rng(seed)
    spacing = 1.0 / round(len(ic["m"]) ** (1 / 3))
    ic["r"] = ic["r"] + jitter * spacing * rng.standard_normal(ic["r"].shape)
    ic["r"] = np.mod(ic["r"], 1.0)
    ic["v"] = 0.1 * rng.standard_normal(ic["v"].shape)
    return make_sph_state(ic["r"], ic["v"], ic["m"], ic["h"], ic["u"])


@pytest.fixture(scope="module")
def oracle_pair():
    """Same jittered 3D state pushed through both neighbour paths."""
    import jax

    sims = {}
    for neib in ("bruteforce", "kdtree"):
        sim = GradhSphSimulation(make_box_params(neib=neib))
        sim.process_parameters()
        sims[neib] = sim
    state = jittered_state(sims["bruteforce"])
    if sims["kdtree"].use_celllist:
        sims["kdtree"]._plan_grid(state.r, state.h)
    out = {}
    for neib, sim in sims.items():
        out[neib] = jax.jit(sim._build_bootstrap())(state)
    return out


FIELDS = ["h", "rho", "invomega", "hfactor", "u", "pressure", "sound",
          "dudt", "div_v"]


@pytest.mark.parametrize("field", FIELDS)
def test_field_matches_oracle(oracle_pair, field):
    bf = np.asarray(getattr(oracle_pair["bruteforce"], field))
    cl = np.asarray(getattr(oracle_pair["kdtree"], field))
    np.testing.assert_allclose(cl, bf, rtol=1e-10, atol=1e-12)


def test_accel_matches_oracle(oracle_pair):
    bf = np.asarray(oracle_pair["bruteforce"].a)
    cl = np.asarray(oracle_pair["kdtree"].a)
    np.testing.assert_allclose(cl, bf, rtol=1e-9, atol=1e-10)


def test_no_overflow(oracle_pair):
    assert not bool(oracle_pair["kdtree"].neib_overflow)


def test_celllist_run_stable():
    """Short end-to-end run on the cell-list path stays finite and
    conserves momentum."""
    sim = GradhSphSimulation(make_box_params(neib="kdtree"))
    sim.SetupSimulation()
    assert sim.use_celllist
    for _ in range(5):
        sim.main_loop_step()
    r = np.asarray(sim.state.rho)
    assert np.isfinite(r).all()
    m = np.asarray(sim.state.m)
    v = np.asarray(sim.state.v)
    mom = np.abs((m[:, None] * v).sum(0)).max()
    assert mom < 1e-10


def test_verify_all_neighbour_completeness(monkeypatch):
    """GANDALF_VERIFY_ALL=1 (reference VERIFY_ALL / DEBUG_LEVEL=2 runtime
    neighbour verification): a healthy grid run passes the oracle check;
    a corrupted neighbour capacity trips it."""
    import numpy as np
    import pytest

    from gandalf_tpu.params import Parameters
    from gandalf_tpu.sim.simulation import GradhSphSimulation

    monkeypatch.setenv("GANDALF_VERIFY_ALL", "1")
    p = Parameters()
    for k, v in {"ndim": 3, "sim": "gradhsph", "ic": "box", "run_id": "",
                 "dimensionless": 1, "gas_eos": "energy_eqn",
                 "rhofluid1": 1.0, "press1": 1.0,
                 "neib_search": "kdtree", "tend": 1.0}.items():
        p.set(k, v)
    for k in range(3):
        p.set(f"Nlattice1[{k}]", 8)
        p.set(f"boxmin[{k}]", 0.0)
        p.set(f"boxmax[{k}]", 1.0)
        p.set(f"boundary_lhs[{k}]", "periodic")
        p.set(f"boundary_rhs[{k}]", "periodic")
    sim = GradhSphSimulation(p)
    sim.SetupSimulation()
    sim.main_loop_step()       # healthy: must NOT raise

    # corrupt the production result -> the check must fire
    import jax.numpy as jnp

    sim.state = sim.state.replace(rho=sim.state.rho * 1.5)
    with pytest.raises(RuntimeError, match="VERIFY_ALL"):
        sim._verify_neighbour_completeness()


def test_particle_type_masks():
    """icm/cdm/boundary type semantics (ParticleTypeRegister,
    Particle.cpp:31-71): cdm feels gravity but exerts/receives no hydro
    force; boundary particles are inert static walls."""
    import numpy as np
    import jax.numpy as jnp

    from gandalf_tpu.params import Parameters
    from gandalf_tpu.sim.simulation import GradhSphSimulation
    from gandalf_tpu.state import BOUNDARY_TYPE, CDM_TYPE, GAS_TYPE

    p = Parameters()
    for k, v in {"ndim": 3, "sim": "gradhsph", "ic": "python",
                 "run_id": "", "dimensionless": 1,
                 "gas_eos": "energy_eqn", "hydro_forces": 1,
                 "self_gravity": 1, "neib_search": "kdtree",
                 "Nhydro": 80, "tend": 1.0}.items():
        p.set(k, v)
    rng = np.random.default_rng(3)
    N = 80
    r = rng.random((N, 3))
    ptype = np.full(N, GAS_TYPE)
    ptype[:8] = CDM_TYPE
    ptype[8:12] = BOUNDARY_TYPE
    sim = GradhSphSimulation(p)
    sim.ImportArray(r[:, 0], "x")
    sim.ImportArray(r[:, 1], "y")
    sim.ImportArray(r[:, 2], "z")
    sim.ImportArray(np.full(N, 1.0 / N), "m")
    sim.ImportArray(np.full(N, 0.1), "u")
    sim.restart_data["ptype"] = ptype
    sim.SetupSimulation()
    assert not sim.use_celllist   # exotic types fall back to all-pairs

    s = sim.state
    is_cdm = np.asarray(s.ptype) == CDM_TYPE
    is_bnd = np.asarray(s.ptype) == BOUNDARY_TYPE
    a = np.asarray(s.a)
    dudt = np.asarray(s.dudt)
    # cdm: gravity only -> nonzero a (gravity), zero dudt
    assert np.abs(a[is_cdm]).max() > 0.0
    assert np.abs(dudt[is_cdm]).max() == 0.0
    # boundary: inert
    assert np.abs(dudt[is_bnd]).max() == 0.0

    r_b0 = np.asarray(s.r)[is_bnd].copy()
    for _ in range(3):
        sim.main_loop_step()
    r_b1 = np.asarray(sim.state.r)[is_bnd]
    np.testing.assert_allclose(r_b1, r_b0, atol=1e-14)   # static walls
    # gas still evolves
    assert np.abs(np.asarray(sim.state.v)[~(is_cdm | is_bnd)]).max() > 0
