"""Benchmark: SELF-GRAVITATING grad-h SPH particle-steps/sec on one GPU
(the BASELINE.json north-star workload: density + hydro forces +
BH-tree gravity per step).

Prints one JSON line per completed size (the last is the largest):
{"metric", "value", "unit", "vs_baseline", "recompiles_in_window",
"platform", "device_kind", "device_count"}.  Refuses any backend but a
GPU.

Flagship configuration: 3D periodic jittered box, grad-h SPH density +
hydro forces + KD-bucket Barnes-Hut tree gravity (quadrupole,
theta^2 = 0.1, isolated-box model: ewald = 0) + leapfrog KDK, global
timestep, structured-grid (27-shift) neighbour path, float32.

The window (`run_cadence`, shared with chip_smoke.py): the box is built
through the user path (factory -> SetupSimulation), run through two
rebuild-cadence boundaries plus two steps, and then whole cadences of
ntreebuildstep steps through main_loop_steps (host replan and async
bursts included) are timed until one runs without a recompile, at most
two.  The value is that cadence; every timed cadence goes to stderr.

The baseline denominator is the measured reference (GANDALF C++,
single-core -O2, on a 1-core x86_64 VM with g++ 13) running the SAME self-gravitating step on an
open-boundary box (its periodic+gravity mode forces Ewald corrections,
which ours deliberately omits for this comparison; the tree/force work is
identical) — see BASELINE_MEASURED.json `sphgrav3d_particle_steps_per_sec`.

Each size is measured in its OWN subprocess, one at a time, smallest
first, and the largest successful measurement is reported.  The parent
never imports JAX, so exactly one process holds the card at any time.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

WARMUP_CADENCES = 2         # cadence boundaries before timing: their
WARMUP_EXTRA = 2            # replans settle the caps on converged h
MAX_TIMED_CADENCES = 2      # time until a cadence runs without a recompile


def require_gpu(jax) -> None:
    """Fail LOUDLY unless JAX's backend is a GPU: a number measured on a
    CPU fallback would be reported as device throughput."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"bench: backend is {platform!r}, not 'gpu' — refusing to "
            "report CPU numbers as device throughput")


def flagship_params(n_side: int, self_gravity: int = 1):
    """Parameters of the flagship deployment at n_side^3 particles."""
    from gandalf_tpu.params import Parameters

    p = Parameters()
    updates = {
        "run_id": "BENCH", "sim": "gradhsph", "ic": "box", "ndim": 3,
        "dimensionless": 1, "gas_eos": "energy_eqn", "gamma_eos": 1.4,
        "rhofluid1": 1.0, "press1": 1.0, "tend": 1.0e30,
        "tsnapfirst": 1.0e30, "self_gravity": self_gravity, "ewald": 0,
        # rebuild cadence: the KD-bucket replan amortises over
        # ntreebuildstep steps; overflow forces an early replan, so this
        # knob tunes speed, never correctness
        "ntreebuildstep": int(os.environ.get("BENCH_NTB", "32")),
    }
    if os.environ.get("BENCH_MULTIPOLE"):
        updates["multipole"] = os.environ["BENCH_MULTIPOLE"]
    for k in range(3):
        updates[f"boxmin[{k}]"] = 0.0
        updates[f"boxmax[{k}]"] = 1.0
        updates[f"boundary_lhs[{k}]"] = "periodic"
        updates[f"boundary_rhs[{k}]"] = "periodic"
        updates[f"Nlattice1[{k}]"] = n_side
    for k, v in updates.items():
        p.set(k, v)
    return p


def jitter_box(ic: dict, n_side: int, seed: int = 42) -> None:
    """Jitter the lattice (0.2 spacing rms, periodic wrap) and give it a
    0.05 rms velocity field, so the h iteration and binning do realistic
    work.  Modifies `ic` in place."""
    rng = np.random.default_rng(seed)
    spacing = 1.0 / n_side
    ic["r"] = np.mod(ic["r"] + 0.2 * spacing
                     * rng.standard_normal(ic["r"].shape), 1.0)
    ic["v"] = 0.05 * rng.standard_normal(ic["v"].shape)


def build_sim(n_side: int, self_gravity: int = 1):
    """The flagship simulation with its parameters processed and nothing
    set up, for tools that plan and step it by hand."""
    from gandalf_tpu.sim.simulation import GradhSphSimulation

    sim = GradhSphSimulation(flagship_params(n_side, self_gravity))
    sim.process_parameters()
    return sim


def flagship_sim(n_side: int, nmpi: int = 0, ntb: int = None,
                 self_gravity: int = 1):
    """The flagship box, jittered, set up through the user path:
    factory, `ic = python` imports, SetupSimulation.  `ntb` overrides
    the rebuild cadence."""
    from gandalf_tpu.sim.ic import generate_ic
    from gandalf_tpu.sim.simulation import SimulationBase

    params = flagship_params(n_side, self_gravity)
    params.set("Nmpi", nmpi)
    if ntb is not None:
        params.set("ntreebuildstep", ntb)
    sim = SimulationBase.factory(params)
    sim.process_parameters()
    ic = generate_ic(sim.params, sim.eos)
    jitter_box(ic, n_side)
    sim.SetParam("ic", "python")
    for k, name in enumerate("xyz"):
        sim.ImportArray(ic["r"][:, k], name)
        sim.ImportArray(ic["v"][:, k], "v" + name)
    for name in ("m", "h", "u"):
        sim.ImportArray(ic[name], name)
    sim.SetupSimulation()
    return sim


def advance(sim, n: int) -> None:
    done = 0
    while done < n:
        done += sim.main_loop_steps(n - done)


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.total = 0.0

    def __call__(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


def run_cadence(sim, clock, warmup_cadences: int = WARMUP_CADENCES,
                max_cadences: int = MAX_TIMED_CADENCES) -> dict:
    """The measurement window.  Warm up through `warmup_cadences` cadence
    boundaries plus WARMUP_EXTRA steps (their replans grow the walk caps
    to the developed flow and recompile), then time whole rebuild
    cadences (ntreebuildstep steps, each with its host replan and async
    bursts) until one triggers no recompile, at most `max_cadences`.
    Every timed cadence is printed; the result is the last one timed."""
    ntb = sim.params.intparams["ntreebuildstep"]
    N = getattr(sim, "_n_orig", sim.state.N)    # sharded: real particles
    advance(sim, warmup_cadences * ntb + WARMUP_EXTRA)
    float(sim.state.t)
    for _ in range(max_cadences):
        rec0, c0, s0 = sim.n_recompiles, clock.total, sim.Nsteps
        t0 = time.perf_counter()
        advance(sim, ntb)
        t_end = float(sim.state.t)          # forces full completion
        elapsed = time.perf_counter() - t0
        res = {"N": N, "steps": sim.Nsteps - s0, "seconds": elapsed,
               "particle_steps_per_sec": N * (sim.Nsteps - s0) / elapsed,
               "recompiles_in_window": sim.n_recompiles - rec0,
               "compile_s_in_window": clock.total - c0}
        print(f"cadence: {json.dumps(res)}", flush=True)
        if res["recompiles_in_window"] == 0:
            break
    rho = np.asarray(sim.state.rho)
    if not (np.isfinite(t_end) and np.isfinite(rho).all()
            and rho.min() > 0.0):
        raise RuntimeError("non-finite or non-positive state after cadence")
    if bool(sim.state.neib_overflow):
        raise RuntimeError("neighbour overflow unresolved after cadence")
    return res


def measure(n_side: int, self_gravity: int = 1) -> dict:
    """Build the flagship box at n_side^3 and time its window
    (run_cadence) on the GPU; raises on any failure."""
    import jax
    import jax.monitoring

    from gandalf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    require_gpu(jax)
    clock = CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    res = run_cadence(flagship_sim(n_side, self_gravity=self_gravity),
                      clock)
    dev = jax.devices()[0]
    return dict(res, platform=dev.platform, device_kind=dev.device_kind,
                device_count=len(jax.devices()))


def _child() -> int:
    out = measure(int(os.environ["BENCH_NSIDE"]),
                  int(os.environ.get("BENCH_GRAVITY", "1")))
    print("BENCH_RESULT " + json.dumps(out))
    return 0


def _load_baseline(N: int, gravity: bool = True):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BASELINE_MEASURED.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        baseline = json.load(f)
    key = "sphgrav3d_particle_steps_per_sec" if gravity \
        else "sph3d_particle_steps_per_sec"
    table = baseline.get(key, {})
    ref = table.get(str(N))
    if ref is None and table:
        # nearest measured size (reference cost/particle is ~flat in N)
        sizes = sorted(int(k) for k in table)
        nearest = min(sizes, key=lambda s: abs(np.log(s / N)))
        ref = table[str(nearest)]
    if ref is None:
        ref = baseline.get(key + "_any")
    return float(ref) if ref else None


def _emit(best, gravity: bool) -> None:
    """Print the best-so-far result as a full JSON line.

    Called after EVERY size, so that a timeout of the whole bench still
    leaves the largest completed measurement as the last line on stdout."""
    name = "sphgrav3d" if gravity else "sph3d"
    N = best["N"]
    val = best["particle_steps_per_sec"]
    ref = _load_baseline(N, gravity=gravity)
    print(json.dumps({
        "metric": f"{name}_particle_steps_per_sec_N{N}",
        "value": round(val, 1),
        "unit": "particle-steps/s/device",
        "vs_baseline": round(val / ref, 3) if ref else 0.0,
        "recompiles_in_window": best["recompiles_in_window"],
        "platform": best["platform"],
        "device_kind": best["device_kind"],
        "device_count": best["device_count"],
    }), flush=True)


def main() -> int:
    if os.environ.get("BENCH_CHILD") == "1":
        return _child()

    sizes = [int(s) for s in os.environ.get(
        "BENCH_SIZES", "16,64,100").split(",")]
    gravity = bool(int(os.environ.get("BENCH_GRAVITY", "1")))
    t_start = time.perf_counter()
    budget = float(os.environ.get("BENCH_BUDGET", "2100"))
    best = None
    for n_side in sizes:
        remaining = budget - (time.perf_counter() - t_start)
        if remaining < 30:
            print(f"bench: budget exhausted before n_side={n_side}",
                  file=sys.stderr)
            break
        env = dict(os.environ, BENCH_CHILD="1", BENCH_NSIDE=str(n_side))
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__)],
                env=env, capture_output=True, text=True, timeout=remaining)
        except subprocess.TimeoutExpired:
            print(f"bench: n_side={n_side} timed out", file=sys.stderr)
            break
        lines = proc.stdout.splitlines()
        for ln in lines:
            if ln.startswith("cadence: "):
                print(f"bench: n_side={n_side} {ln}", file=sys.stderr)
        line = [ln for ln in lines if ln.startswith("BENCH_RESULT ")]
        if proc.returncode != 0 or not line:
            print(f"bench: n_side={n_side} failed "
                  f"(rc={proc.returncode})\n" + proc.stderr[-2000:],
                  file=sys.stderr)
            break
        best = json.loads(line[-1][len("BENCH_RESULT "):])
        _emit(best, gravity)
    return 0 if best is not None else 1


if __name__ == "__main__":
    sys.exit(main())
