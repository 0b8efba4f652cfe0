"""Device bring-up pieces that say something without a GPU: compile-cache
placement, the bench's platform gate and measurement window, pair-slab
sizing from device memory, the smoothed tree walk against its all-pairs
oracle, and chip_smoke.py's sampled-oracle comparison at small N.  The GPU
half of chip_smoke.py runs under the `gpu` marker (skips here)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
from gandalf_tpu.ops import sph_grid27 as g
from gandalf_tpu.utils import compile_cache


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(env_dir, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and no other directory is named;
    without it the cache sits at the fixed in-checkout path."""
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        want = compile_cache.DEFAULT_DIR
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv(compile_cache.ENV_VAR, want)
    try:
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert compile_cache.DEFAULT_DIR == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")


def test_bench_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="not 'gpu'"):
        bench.require_gpu(jax)


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform, self._stats = platform, stats
        self.device_kind = platform + "-fake"

    def memory_stats(self):
        return self._stats


def test_device_bytes_limit_sources():
    assert g.device_bytes_limit(
        _FakeDevice("gpu", {"bytes_limit": 12345})) == 12345
    assert g.device_bytes_limit(_FakeDevice("cpu", None)) == \
        os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") \
        // len(jax.devices("cpu"))
    with pytest.raises(RuntimeError, match="bytes_limit"):
        g.device_bytes_limit(_FakeDevice("gpu", None))


@pytest.mark.parametrize("concat", [True, False])
def test_auto_slab_hand_count(concat):
    """Slab rows = budget // (ny*nx cells * K * cols * itemsize * temps),
    with no tile padding anywhere."""
    spec = g.Grid27Spec(ndim=3, ncells=(30, 20, 10), lo=(0.0,) * 3,
                        extents=(1.0,) * 3, k_cell=43,
                        periodic=(True,) * 3)
    cols = 43 * 27 if concat else 43
    row_bytes = 20 * 10 * 43 * cols * 4 * g.SLAB_PAIR_TEMPS
    limit = 80 * 10 ** 9
    want = int(g.SLAB_MEMORY_FRACTION * limit) // row_bytes
    assert want > 1
    assert g._auto_slab(spec, concat=concat, itemsize=4,
                        bytes_limit=limit) == want
    # a budget below one row still processes one row per slab
    assert g._auto_slab(spec, concat=concat, bytes_limit=1000) == 1


def test_smoothed_tree_matches_direct_oracle():
    """The walk's difference-form near field + kernel-support tier against
    direct_sph_gravity (float64, small theta so truncation is small)."""
    from gandalf_tpu.kernels.smoothing import kernel_factory
    from gandalf_tpu.ops.sph_gravity import direct_sph_gravity
    from gandalf_tpu.ops.tree import (plan_buckets_kd,
                                      plan_tree_for_buckets,
                                      tree_gravity_grouped)

    rng = np.random.default_rng(4)
    N = 2048
    r = rng.standard_normal((N, 3)) * np.array([1.0, 0.6, 0.4])
    m = rng.random(N) * (2.0 / N)
    h = 0.15 * (1.0 + rng.random(N))
    zh = 0.1 * rng.standard_normal(N)
    kern = kernel_factory("m4", 3)
    gmap = plan_buckets_kd(r, leaf_size=32)
    spec = plan_tree_for_buckets(gmap, theta_sqd=0.02, quadrupole=True,
                                 near_cap=64, frontier=512)
    a_t, gpot_t, ovf = tree_gravity_grouped(
        spec, jnp.asarray(gmap), jnp.asarray(r), jnp.asarray(m),
        jnp.asarray(h), kern, zh=jnp.asarray(zh))
    assert not bool(ovf)
    ref = direct_sph_gravity(kern, jnp.asarray(r), jnp.asarray(m),
                             jnp.asarray(h), jnp.asarray(zh),
                             jnp.ones(N))
    a_ref = np.asarray(ref.a)
    err = (np.linalg.norm(np.asarray(a_t) - a_ref, axis=-1)
           / np.linalg.norm(a_ref, axis=-1))
    assert np.sqrt(np.mean(err ** 2)) < 3e-4, np.sqrt(np.mean(err ** 2))
    perr = np.abs(np.asarray(gpot_t) / np.asarray(ref.gpot) - 1.0)
    assert np.median(perr) < 1e-4, np.median(perr)


def test_direct_gravity_targets_match_full():
    """The oracle's target subset is the same sum as the full evaluation."""
    from gandalf_tpu.kernels.smoothing import kernel_factory
    from gandalf_tpu.ops.sph_gravity import direct_sph_gravity

    rng = np.random.default_rng(1)
    N = 300
    r, m = rng.random((N, 3)), rng.random(N) / N
    h, zeta, hf = 0.1 + 0.1 * rng.random(N), rng.random(N), rng.random(N)
    kern = kernel_factory("m4", 3)
    full = direct_sph_gravity(kern, r, m, h, zeta, hf)
    t = np.array([0, 7, 150, 299])
    sub = direct_sph_gravity(kern, r, m, h, zeta, hf, targets=t)
    np.testing.assert_allclose(np.asarray(sub.a), np.asarray(full.a)[t],
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(np.asarray(sub.gpot),
                               np.asarray(full.gpot)[t], rtol=1e-13)


@pytest.fixture(scope="module")
def small_flagship():
    """The flagship box at 10^3 particles, a few steps in."""
    sim = bench.flagship_sim(10)
    bench.advance(sim, 3)
    return sim


def test_chip_smoke_oracle_small(small_flagship):
    err = chip_smoke.oracle_errors(small_flagship, n_sample=256, chunk=64)
    assert err["n_targets"] == 256 and err["n_sources"] == 1000
    assert chip_smoke.oracle_failures(err) == [], err
    # float64 on both sides: only the tree's multipole truncation is left
    assert err["rho_max_rel"] < 1e-10 and err["h_max_rel"] < 1e-10
    assert err["hydro_median"] < 1e-9


def test_bucket_images_match_walk_unwrap():
    """The oracle's numpy unwrap places every bucket member at the image
    the walk's own unwrap (unwrap_to_buckets) gives it, across seams."""
    from gandalf_tpu.ops.tree import plan_tree, unwrap_to_buckets

    rng = np.random.default_rng(7)
    L, n_leaves = 8, 16
    spec = plan_tree(n_leaves * L, leaf_size=L)
    ext = [1.0, 2.0, 0.0]                   # z open
    centres = rng.random((n_leaves, 3)) * np.array([1.0, 2.0, 1.0])
    r_g = centres[:, None, :] + 0.05 * rng.standard_normal((n_leaves, L, 3))
    r_g[..., :2] = np.mod(r_g[..., :2], ext[:2])   # wrap into the box
    gmap = np.arange(n_leaves * L).reshape(n_leaves, L)
    gmap[3, :2] = -1                        # empty first slots
    gmap[5, :] = -1                         # an empty bucket
    perm = rng.permutation(n_leaves * L)    # ids are not slot order
    r = np.empty((n_leaves * L, 3))
    r[perm] = r_g.reshape(-1, 3)
    ids = np.where(gmap >= 0, perm[np.maximum(gmap, 0)], -1)
    got = chip_smoke.bucket_images(r, ids, ext)
    flat = ids.reshape(-1)
    in_map = flat >= 0
    r_s = np.where(in_map[:, None], r[np.maximum(flat, 0)], 1e15)
    want = np.asarray(unwrap_to_buckets(spec, jnp.asarray(r_s),
                                        jnp.asarray(in_map), ext))
    np.testing.assert_allclose(got[flat[in_map]], want[in_map],
                               rtol=0, atol=1e-12)
    assert np.abs(got - r).max() > 0.5      # some member crossed a seam
    assert chip_smoke.bucket_images(r, ids, None) is r


def test_run_cadence_times_one_cadence(capsys):
    """bench.run_cadence warms up, then times whole cadences until one
    runs without a recompile, on the user-path box."""
    sim = bench.flagship_sim(8, ntb=4)
    res = bench.run_cadence(sim, bench.CompileClock())
    timed = [json.loads(ln[len("cadence: "):])
             for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("cadence: ")]
    assert 1 <= len(timed) <= bench.MAX_TIMED_CADENCES
    assert timed[-1] == res and res["steps"] == 4 and res["N"] == 512
    # a further cadence is timed only after one that recompiled
    assert all(c["recompiles_in_window"] > 0 for c in timed[:-1])
    assert sim.Nsteps == (bench.WARMUP_CADENCES * 4 + bench.WARMUP_EXTRA
                          + 4 * len(timed))
    assert res["particle_steps_per_sec"] == pytest.approx(
        512 * 4 / res["seconds"])


def test_oracle_failures_names_each_gate():
    ok = {"rho_max_rel": 0.0, "h_max_rel": 0.0, "hydro_median": 0.0,
          "hydro_mean": 0.0, "grav_rms": 0.0}
    assert chip_smoke.oracle_failures(ok) == []
    bad = dict(ok, grav_rms=2e-3, h_max_rel=float("nan"))
    msgs = chip_smoke.oracle_failures(bad)
    assert len(msgs) == 2 and any("grav_rms" in s for s in msgs) \
        and any("h_max_rel" in s for s in msgs)


def test_accel_parity_measure():
    a = np.array([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, 3.0]])
    med, p99 = chip_smoke.accel_parity(a, a)
    assert med == 0.0 and p99 == 0.0
    b = a.copy()
    b[0, 0] += 0.02          # |a| = 1 < mean 2: normalised by the mean
    med, p99 = chip_smoke.accel_parity(b, a)
    assert med == 0.0 and p99 == pytest.approx(0.0098, rel=1e-6)


@pytest.mark.gpu
def test_flagship_oracle_on_gpu(gpu):
    """The float32 device path against the float64 oracles (the small
    version of chip_smoke.py's oracle phase)."""
    with jax.enable_x64(False):
        sim = bench.flagship_sim(24)
        bench.advance(sim, 4)
        assert sim.state.r.dtype == jnp.float32
        err = chip_smoke.oracle_errors(sim, n_sample=512)
    assert chip_smoke.oracle_failures(err) == [], err
