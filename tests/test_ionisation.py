"""Photoionisation (vectorised re-design of MultipleSourceIonisation,
src/Thermal/MultipleSourceIonisation.cpp): the ionised region around a
source in uniform gas must match the analytic Stromgren radius."""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

import jax.numpy as jnp

from gandalf_tpu.ops.ionisation import (IonisationConfig, apply_ionisation,
                                        ionisation_fractions,
                                        stromgren_radius)


def test_uniform_stromgren_sphere():
    rng = np.random.default_rng(2)
    N = 20000
    L = 1.0
    r = rng.uniform(-L, L, (N, 3))
    rho0 = 1.0
    m = np.full(N, rho0 * (2 * L) ** 3 / N)
    cfg = IonisationConfig(alphaB=1.0, mu_bar=1.0)
    n_H = rho0 / cfg.mu_bar
    Rs = 0.5
    ndot = 4.0 * np.pi / 3.0 * cfg.alphaB * n_H * n_H * Rs ** 3
    assert stromgren_radius(ndot, n_H, cfg.alphaB) == pytest.approx(Rs)

    ion = ionisation_fractions(
        cfg, jnp.asarray(r), jnp.asarray(m), jnp.full(N, rho0),
        jnp.zeros((1, 3)), jnp.asarray([ndot]), jnp.asarray([True]))
    ion = np.asarray(ion)
    d = np.sqrt((r ** 2).sum(-1))
    # ionised exactly inside the Stromgren radius (Monte-Carlo sampling
    # noise at the front)
    assert abs(d[ion].max() - Rs) < 0.03
    assert ion[d < 0.8 * Rs].all()
    assert not ion[d > 1.1 * Rs].any()


def test_two_sources_union():
    rng = np.random.default_rng(3)
    N = 8000
    r = rng.uniform(-2, 2, (N, 3))
    m = np.full(N, 4.0 ** 3 / N)
    cfg = IonisationConfig(alphaB=1.0, mu_bar=1.0)
    ndot = 4.0 * np.pi / 3.0 * 0.3 ** 3
    src = np.array([[-1.0, 0, 0], [1.0, 0, 0]])
    ion = np.asarray(ionisation_fractions(
        cfg, jnp.asarray(r), jnp.asarray(m), jnp.ones(N),
        jnp.asarray(src), jnp.asarray([ndot, ndot]),
        jnp.asarray([True, True])))
    d1 = np.sqrt(((r - src[0]) ** 2).sum(-1))
    d2 = np.sqrt(((r - src[1]) ** 2).sum(-1))
    assert ion[(d1 < 0.25)].all() and ion[(d2 < 0.25)].all()
    assert not ion[(d1 > 0.4) & (d2 > 0.4)].any()
    # inactive source ionises nothing
    ion0 = np.asarray(ionisation_fractions(
        cfg, jnp.asarray(r), jnp.asarray(m), jnp.ones(N),
        jnp.asarray(src), jnp.asarray([ndot, ndot]),
        jnp.asarray([True, False])))
    assert not ion0[(d2 < 0.25) & (d1 > 0.4)].any()


def test_apply_ionisation_temperatures():
    cfg = IonisationConfig(temp_ion=1e4, temp_neutral=10.0,
                           mu_ion=0.678, mu_bar=2.35)
    ion = jnp.asarray([True, False])
    u = jnp.asarray([1.0, 1.0])
    u_new, temp = apply_ionisation(cfg, 2.0 / 3.0, ion, u)
    assert float(u_new[0]) == pytest.approx(1e4 / (2 / 3) / 0.678)
    assert float(temp[1]) == 10.0


class TestMultiSourceCoupled:
    """Iterated coupled balance (MultipleSourceIonisation.cpp:55-769)."""

    def _uniform(self, N=20000, L=1.5, seed=5):
        rng = np.random.default_rng(seed)
        r = rng.uniform(-L, L, (N, 3))
        m = np.full(N, (2 * L) ** 3 / N)
        return r, m

    def test_single_source_matches_independent(self):
        from gandalf_tpu.ops.ionisation import multi_source_ionisation

        r, m = self._uniform()
        cfg = IonisationConfig(alphaB=1.0, mu_bar=1.0)
        ndot = 4.0 * np.pi / 3.0 * 0.5 ** 3
        args = (cfg, jnp.asarray(r), jnp.asarray(m),
                jnp.ones(len(r)), jnp.zeros((1, 3)), jnp.asarray([ndot]),
                jnp.asarray([True]))
        ion_a = np.asarray(ionisation_fractions(*args))
        ion_b = np.asarray(multi_source_ionisation(*args))
        np.testing.assert_array_equal(ion_a, ion_b)

    def test_coincident_sources_share_budget(self):
        """Two sources at the SAME spot with Ndot/2 each must together
        carve the same Stromgren sphere as one source with Ndot — the
        independent treatment double-charges recombination and ionises
        only (1/2)^(1/3) of the radius."""
        from gandalf_tpu.ops.ionisation import multi_source_ionisation

        r, m = self._uniform()
        cfg = IonisationConfig(alphaB=1.0, mu_bar=1.0)
        Rs = 0.5
        ndot = 4.0 * np.pi / 3.0 * Rs ** 3
        src2 = jnp.zeros((2, 3))
        ion = np.asarray(multi_source_ionisation(
            cfg, jnp.asarray(r), jnp.asarray(m), jnp.ones(len(r)),
            src2, jnp.asarray([ndot / 2, ndot / 2]),
            jnp.asarray([True, True])))
        d = np.sqrt((r ** 2).sum(-1))
        assert abs(d[ion].max() - Rs) < 0.04
        assert ion[d < 0.8 * Rs].all()
        # the uncoupled balance would stop at Rs/2^(1/3) ~ 0.397
        ion_ind = np.asarray(ionisation_fractions(
            cfg, jnp.asarray(r), jnp.asarray(m), jnp.ones(len(r)),
            src2, jnp.asarray([ndot / 2, ndot / 2]),
            jnp.asarray([True, True])))
        assert d[ion_ind].max() < 0.45

    def test_overlapping_sources_grow(self):
        """Partially-merged regions: the coupled front must extend beyond
        the independent one."""
        from gandalf_tpu.ops.ionisation import multi_source_ionisation

        r, m = self._uniform()
        cfg = IonisationConfig(alphaB=1.0, mu_bar=1.0)
        ndot = 4.0 * np.pi / 3.0 * 0.5 ** 3
        src = jnp.asarray([[-0.3, 0.0, 0.0], [0.3, 0.0, 0.0]])
        nd2 = jnp.asarray([ndot, ndot])
        act = jnp.asarray([True, True])
        args = (cfg, jnp.asarray(r), jnp.asarray(m), jnp.ones(len(r)))
        ion_c = np.asarray(multi_source_ionisation(*args, src, nd2, act))
        ion_i = np.asarray(ionisation_fractions(*args, src, nd2, act))
        assert ion_c.sum() > ion_i.sum()
        assert ion_c[ion_i].all()  # coupled is a superset
