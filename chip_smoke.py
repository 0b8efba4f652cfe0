#!/usr/bin/env python3
"""Smoke test of the production path on the GPU, checked against the
float64 oracles.

    python chip_smoke.py           one GPU (all phases below)
    python chip_smoke.py --four    four GPUs: the distributed phase only

One GPU, one process (a JAX process reserves most of the card):

  sod       `python -m gandalf_tpu` (its main()) on examples/adsod.dat at
            the reference test's resolution, in a temporary directory;
            gate L1(vx) < 9e-3 (tests/test_adsod.py).
  flagship  the 1M-particle self-gravitating grad-h SPH box of bench.py
            through SimulationBase.factory -> SetupSimulation ->
            main_loop_steps, timed as particle-steps/s over bench.py's
            window (bench.run_cadence): the first rebuild cadence (host
            replan + async bursts) without a recompile after warm-up.
  oracle    on the state after the cadence, the production hydro and
            gravity passes run again and are compared at N_SAMPLE random
            targets, against every source, with the float64 oracles.

--four runs the distributed controller (Nmpi = 4, one process driving
four cards) on the same box, the same steps on one device, compares the
two, and runs the oracle check on the single-device state.

Every phase prints its wall and compile time; any failure exits non-zero
before the last line, which is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_SIDE = 100                # 100^3 = 1M particles, bench.py's flagship size
N_SAMPLE = 2048             # oracle targets, each against all sources
FOUR_NTB = 8                # --four: cadence length (4 cards cost 4x)

# Gates, each the repo's own (reasons in PERF.md):
SOD_L1_VX = 9e-3            # tests/test_adsod.py
GRAV_RMS = 1e-3             # tests/test_treeerror.py, theta^2 = 0.1 quad
HYDRO_MEDIAN = 3e-3         # tests/test_grid_path.py
HYDRO_MEAN = 2e-2           # tests/test_grid_path.py
RHO_H_MAX = 1e-3            # f32 sums over ~58 neighbours + h_converge
DIST_MEDIAN = 1e-3          # tests/test_dist.py truncation parity
DIST_P99 = 1e-2

SOD_OVERRIDES = """
Lattice 1 : Nlattice1[0] = 512
Lattice 2 : Nlattice2[0] = 128
End time : tend = 0.5
Snapshot interval : dt_snap = 0.25
Output format : out_file_form = column
Courant : courant_mult = 0.2
Accel : accel_mult = 0.4
Energy : energy_mult = 0.5
"""


def run_phase(name, fn, clock):
    """Run one phase, print its wall and compile seconds, return its
    result.  Exceptions propagate: a failed phase fails the script."""
    c0, t0 = clock.total, time.perf_counter()
    out = fn()
    print(f"phase {name}: wall {time.perf_counter() - t0:.1f} s, "
          f"compile {clock.total - c0:.1f} s", flush=True)
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


# -- phases -----------------------------------------------------------------
def phase_sod() -> float:
    from gandalf_tpu.__main__ import main as gandalf_main
    from gandalf_tpu.analysis.riemann import shocktube_solution
    from gandalf_tpu.sim.io import read_column_snapshot

    with tempfile.TemporaryDirectory() as tmp:
        dat = os.path.join(tmp, "adsod.dat")
        with open(os.path.join(HERE, "examples", "adsod.dat")) as f:
            text = f.read()
        with open(dat, "w") as f:
            f.write(text + SOD_OVERRIDES)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            rc = gandalf_main([dat])
        finally:
            os.chdir(cwd)
        if rc != 0:
            raise RuntimeError(f"python -m gandalf_tpu exited {rc}")
        t, data = read_column_snapshot(
            sorted(glob.glob(os.path.join(tmp, "ADSOD.column.*")))[-1])
    if t < 0.5:
        raise RuntimeError(f"Sod run stopped at t = {t}")
    x = data["r"][:, 0]
    vx = data["v"][:, 0]
    sel = (x > -1.0) & (x < 1.0)
    sol = shocktube_solution(1.0, 0.0, 1.0, 0.25, 0.0, 0.1975, 1.4,
                             -1.0, 0.0, 1.0, t)
    l1 = float(np.abs(vx[sel] - np.interp(x[sel], sol["x"],
                                          sol["vx"])).mean())
    print(f"sod: t = {t:.4f}, L1(vx) = {l1:.3e} (gate {SOD_L1_VX})")
    if not l1 < SOD_L1_VX:
        raise RuntimeError(f"Sod L1(vx) = {l1} >= {SOD_L1_VX}")
    return l1


# -- oracle comparison --------------------------------------------------------
def bucket_images(r: np.ndarray, bucket_map: np.ndarray,
                  extent) -> np.ndarray:
    """Positions as the isolated-box (ewald = 0) gravity walk sees them,
    from the bucket membership alone: every member of a bucket takes the
    periodic image nearest the bucket's first member.  Plain numpy,
    independent of the walk's own unwrap.  `bucket_map` rows are buckets
    of particle ids (-1 = empty slot); `extent` is the box length per
    axis (0 = open), or None for an open box."""
    if extent is None:
        return r
    ext = np.asarray(extent, np.float64)
    real = bucket_map >= 0
    first = bucket_map[np.arange(len(bucket_map)), real.argmax(axis=1)]
    ids = bucket_map[real]
    anchor = r[np.repeat(first, real.sum(axis=1))]
    d = r[ids] - anchor
    per = ext > 0
    d = np.where(per, d - ext * np.round(d / np.where(per, ext, 1.0)), d)
    out = r.copy()
    out[ids] = anchor + d
    return out


def oracle_errors(sim, n_sample: int = N_SAMPLE, seed: int = 0,
                  chunk: int = 32, k_nb: int = 256) -> dict:
    """Re-run the production hydro pass and self-gravity on sim.state and
    compare `n_sample` random live targets, each against every source,
    with the float64 oracles: compute_h_bruteforce (h, rho),
    compute_hydro_forces over all sources within kernel support
    (hydro acceleration, fed the production per-particle fields), and
    direct_sph_gravity on the positions of bucket_images
    (gravitational acceleration)."""
    import jax
    import jax.numpy as jnp

    from gandalf_tpu.ops.density import compute_h_bruteforce
    from gandalf_tpu.ops.forces import NeighborView, compute_hydro_forces
    from gandalf_tpu.ops.sph_gravity import direct_sph_gravity
    from gandalf_tpu.state import GAS_TYPE

    s0 = sim.state
    if bool((np.asarray(s0.ptype) != GAS_TYPE).any()):
        raise ValueError("the gravity oracle takes every live particle as "
                         "gravitating gas")
    hyd = jax.jit(sim._hydro_only_pass)(s0)
    a_grav, _, ovf = jax.jit(sim._self_gravity)(hyd)
    if bool(hyd.neib_overflow) or bool(ovf):
        raise RuntimeError("production recompute overflowed its caps")
    f64 = lambda x: np.asarray(x, np.float64)
    alive = np.asarray(s0.alive)
    r = f64(s0.r)
    fields = {k: f64(getattr(hyd, k)) for k in
              ("m", "h", "rho", "u", "pressure", "sound", "invomega",
               "hfactor", "alpha", "zeta")}
    fields["m"] = np.where(alive, fields["m"], 0.0)
    v = f64(s0.v)
    h_start = f64(s0.h)
    a_hydro = f64(hyd.a)
    a_grav = f64(a_grav)
    r_tree = bucket_images(
        r, np.asarray(s0.bucket_map).reshape(-1, sim.treespec.leaf_size),
        sim._periodic_extent())
    rng = np.random.default_rng(seed)
    n_sample = min(n_sample, int(alive.sum()))
    n_sample -= n_sample % chunk if n_sample >= chunk else 0
    chunk = min(chunk, n_sample)
    tgt = np.sort(rng.choice(np.nonzero(alive)[0], n_sample,
                             replace=False))
    kern, box, visc = sim.kern, sim.box, sim.visc
    k_nb = min(k_nb, len(r))
    support2 = (kern.kernrange * fields["h"][alive].max()) ** 2

    def dens(rt, mt, ht, rs, ms):
        return compute_h_bruteforce(kern, box, sim.h_fac, sim.h_converge,
                                    rt, mt, ht, rs, ms)

    def hydro(t, rs, vs, f):
        dr = box.min_image(rs[None, :, :] - rs[t][:, None, :])
        d2 = jnp.sum(dr * dr, axis=-1)
        neg, nb = jax.lax.top_k(-d2, k_nb)       # nearest k_nb sources
        # every source within support must be in the view: the farthest
        # kept neighbour lies beyond the largest pair support
        reach = jnp.min(-neg[:, -1]) if k_nb < rs.shape[0] else jnp.inf
        take = lambda x: x[nb]
        view = NeighborView(
            dr=jnp.take_along_axis(dr, nb[..., None], axis=1),
            v=take(vs), m=take(f["m"]), h=take(f["h"]), rho=take(f["rho"]),
            u=take(f["u"]), pressure=take(f["pressure"]),
            sound=take(f["sound"]), invomega=take(f["invomega"]),
            hfactor=take(f["hfactor"]), alpha=take(f["alpha"]), mask=None)
        out = compute_hydro_forces(
            kern, visc, vs[t], f["h"][t], f["rho"][t], f["u"][t],
            f["pressure"][t], f["sound"][t], f["invomega"][t],
            f["hfactor"][t], f["alpha"][t], view)
        return out.a, reach

    def grav(t, rs, ms, f):
        return direct_sph_gravity(kern, rs, ms, f["h"], f["zeta"],
                                  f["hfactor"], targets=t).a

    with jax.enable_x64(True):
        jd, jh, jg = jax.jit(dens), jax.jit(hydro), jax.jit(grav)
        R, V, RT = jnp.asarray(r), jnp.asarray(v), jnp.asarray(r_tree)
        M = jnp.asarray(fields["m"])
        F = {k: jnp.asarray(x) for k, x in fields.items()}
        rho_ref, h_ref, ah_ref, ag_ref, reach = [], [], [], [], np.inf
        for i in range(0, n_sample, chunk):
            t = tgt[i:i + chunk]
            d = jd(R[t], M[t], jnp.asarray(h_start[t]), R, M)
            rho_ref.append(np.asarray(d.rho))
            h_ref.append(np.asarray(d.h))
            a_h, rch = jh(jnp.asarray(t), R, V, F)
            ah_ref.append(np.asarray(a_h))
            reach = min(reach, float(rch))
            ag_ref.append(np.asarray(jg(jnp.asarray(t), RT, M, F)))
    if not reach > support2:
        raise RuntimeError("hydro oracle view misses sources within "
                           "kernel support; raise k_nb")
    rho_ref, h_ref = np.concatenate(rho_ref), np.concatenate(h_ref)
    ah_ref, ag_ref = np.concatenate(ah_ref), np.concatenate(ag_ref)
    herr = (np.linalg.norm(a_hydro[tgt] - ah_ref, axis=-1)
            / np.linalg.norm(ah_ref, axis=-1).mean())
    gerr = (np.linalg.norm(a_grav[tgt] - ag_ref, axis=-1)
            / np.maximum(np.linalg.norm(ag_ref, axis=-1), 1e-30))
    return {
        "n_targets": int(n_sample), "n_sources": int(alive.sum()),
        "rho_max_rel": float(np.abs(fields["rho"][tgt] / rho_ref
                                    - 1.0).max()),
        "h_max_rel": float(np.abs(fields["h"][tgt] / h_ref - 1.0).max()),
        "hydro_median": float(np.median(herr)),
        "hydro_mean": float(herr.mean()),
        "grav_rms": float(np.sqrt(np.mean(gerr ** 2))),
    }


def oracle_failures(err: dict) -> list:
    """Gates the oracle errors miss, as messages (empty = all pass)."""
    gates = (("rho_max_rel", RHO_H_MAX), ("h_max_rel", RHO_H_MAX),
             ("hydro_median", HYDRO_MEDIAN), ("hydro_mean", HYDRO_MEAN),
             ("grav_rms", GRAV_RMS))
    return [f"{k} = {err[k]:.3e} >= {lim}" for k, lim in gates
            if not err[k] < lim]


def phase_oracle(sim) -> dict:
    err = oracle_errors(sim)
    print("oracle: " + json.dumps(err))
    bad = oracle_failures(err)
    if bad:
        raise RuntimeError("oracle gates failed: " + "; ".join(bad))
    return err


def accel_parity(a_test: np.ndarray, a_ref: np.ndarray) -> tuple:
    """(median, p99) of |a_test - a_ref| / max(|a_ref|, mean |a_ref|),
    the distributed tests' truncation-parity measure."""
    mag = np.linalg.norm(a_ref, axis=-1)
    err = (np.linalg.norm(a_test - a_ref, axis=-1)
           / np.maximum(mag, mag.mean()))
    return float(np.median(err)), float(np.percentile(err, 99))


def phase_four(clock) -> dict:
    import jax

    from bench import advance, flagship_sim, run_cadence

    n_dev = len(jax.devices())
    if n_dev < 4:
        raise RuntimeError(f"--four needs 4 devices, JAX sees {n_dev}")
    dist = run_phase("four:setup",
                     lambda: flagship_sim(N_SIDE, nmpi=4, ntb=FOUR_NTB),
                     clock)
    shard_devs = sorted({str(sh.device)
                         for sh in dist.state.r.addressable_shards})
    print(f"four: shards of r on {shard_devs}")
    if len(shard_devs) != 4:
        raise RuntimeError(f"state sits on {len(shard_devs)} devices, "
                           "not 4")
    # the distributed replan re-decomposes and recompiles at every
    # cadence, so warm-up cadences would buy nothing: setup + one cadence
    res = run_phase("four:cadence",
                    lambda: run_cadence(dist, clock, warmup_cadences=0,
                                        max_cadences=1), clock)
    print(f"four: {res['particle_steps_per_sec']:.1f} particle-steps/s "
          f"on 4 devices ({json.dumps(res)})")
    single = run_phase("four:single-setup",
                       lambda: flagship_sim(N_SIDE, ntb=FOUR_NTB), clock)
    run_phase("four:single-steps", lambda: advance(single, dist.Nsteps),
              clock)
    d4 = dist._state_to_host()
    d1 = single._state_to_host()
    med, p99 = accel_parity(d4["a"], d1["a"])
    rho_rel = np.abs(d4["rho"] / d1["rho"] - 1.0)
    out = {"accel_median": med, "accel_p99": p99,
           "rho_median": float(np.median(rho_rel)),
           "rho_p99": float(np.percentile(rho_rel, 99))}
    print("four: sharded vs single-device " + json.dumps(out))
    bad = [f"{k} = {v:.3e} >= {lim}" for k, v, lim in (
        ("accel_median", med, DIST_MEDIAN), ("accel_p99", p99, DIST_P99),
        ("rho_median", out["rho_median"], DIST_MEDIAN),
        ("rho_p99", out["rho_p99"], DIST_P99)) if not v < lim]
    if bad:
        raise RuntimeError("sharded run disagrees: " + "; ".join(bad))
    run_phase("four:oracle", lambda: phase_oracle(single), clock)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU distributed phase")
    args = ap.parse_args()

    import bench
    import gandalf_tpu

    if {os.path.dirname(os.path.abspath(bench.__file__)),
            os.path.dirname(os.path.dirname(os.path.abspath(
                gandalf_tpu.__file__)))} != {HERE}:
        raise SystemExit("bench and gandalf_tpu must come from this "
                         "checkout")
    import jax
    import jax.monitoring

    from gandalf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's backend is {dev.platform!r}")
    card = card_line()
    print(card, flush=True)
    print(f"jax.devices(): {jax.devices()}", flush=True)
    clock = bench.CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)

    if args.four:
        run_phase("four", lambda: phase_four(clock), clock)
    else:
        run_phase("sod", phase_sod, clock)
        sim = run_phase("flagship:setup",
                        lambda: bench.flagship_sim(N_SIDE), clock)
        res = run_phase("flagship:cadence",
                        lambda: bench.run_cadence(sim, clock), clock)
        print(f"flagship: N={res['N']} {res['steps']} steps in "
              f"{res['seconds']:.3f} s = "
              f"{res['particle_steps_per_sec']:.1f} particle-steps/s on "
              f"{card.splitlines()[0]} ({json.dumps(res)})", flush=True)
        run_phase("oracle", lambda: phase_oracle(sim), clock)
    for d in jax.devices():
        stats = d.memory_stats() or {}
        print(f"{d}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
