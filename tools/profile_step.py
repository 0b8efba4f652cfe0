"""Per-pass timing breakdown of the flagship bench step on the GPU.

Times the three dominant sub-programs of the self-gravitating grad-h SPH
step (grid density h-iteration, grid hydro forces, KD-bucket tree
gravity) as SEPARATE jits, plus the full fused step, at a given lattice
size.  Run on the GPU:

    BENCH_NSIDE=100 python tools/profile_step.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from gandalf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bench import build_sim, jitter_box
    from gandalf_tpu.sim.ic import generate_ic
    from gandalf_tpu.state import make_sph_state

    n_side = int(os.environ.get("BENCH_NSIDE", "64"))
    reps = int(os.environ.get("PROFILE_REPS", "5"))
    sim = build_sim(n_side)
    ic = generate_ic(sim.params, sim.eos)
    jitter_box(ic, n_side)
    state = make_sph_state(ic["r"], ic["v"], ic["m"], ic["h"], ic["u"])
    sim.state = state
    sim._plan_grid(ic["r"], ic["h"], growth=1.3)
    sim._plan_tree_buckets(np.asarray(ic["r"]))
    sim._compile()
    state = jax.jit(sim._build_bootstrap())(sim.state)
    state = sim._step_fn(state)
    print(f"N={state.N} ncells={sim.gridspec.ncells} "
          f"K={sim.gridspec.k_cell}", flush=True)

    from gandalf_tpu.ops.sph_grid27 import hydro_pass_grid27
    from gandalf_tpu.ops.tree import tree_gravity_grouped

    def density_only(s):
        out = hydro_pass_grid27(sim.kern, sim.visc, sim.box, sim.gridspec,
                                sim.eos, sim.h_fac, sim.h_converge,
                                hydro_forces=False, s=s, alive=s.alive)
        return out.rho.sum()

    def full_hydro(s):
        out = hydro_pass_grid27(sim.kern, sim.visc, sim.box, sim.gridspec,
                                sim.eos, sim.h_fac, sim.h_converge,
                                hydro_forces=True, s=s, alive=s.alive)
        return out.rho.sum() + out.a.sum()

    def gravity_only(s):
        if sim.treespec.mp_cap > 0 and s.walk_mp is not None:
            from gandalf_tpu.ops.tree import tree_gravity_listed

            a, gpot, ovf = tree_gravity_listed(
                sim.treespec, s.bucket_map, s.walk_mp, s.walk_near,
                s.walk_plan_r, s.walk_anchors, s.walk_margin, s.r, s.m,
                s.h, sim.kern, alive=s.alive, zh=s.zeta * s.hfactor)
        else:
            a, gpot, ovf = tree_gravity_grouped(
                sim.treespec, s.bucket_map, s.r, s.m, s.h, sim.kern,
                alive=s.alive, zh=s.zeta * s.hfactor)
        return a.sum() + gpot.sum()

    def full_step(s):
        return sim._step_fn(s)

    progs = {
        "density(h-iter)": jax.jit(density_only),
        "density+forces": jax.jit(full_hydro),
        "tree gravity": jax.jit(gravity_only),
    }
    for name, fn in progs.items():
        t0 = time.perf_counter()
        v = fn(state)
        jax.block_until_ready(v)
        _ = float(np.asarray(v).ravel()[0])
        compile_t = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            v = fn(state)
        jax.block_until_ready(v)
        _ = float(np.asarray(v).ravel()[0])
        dt = (time.perf_counter() - t0) / reps
        print(f"{name:18s} {dt * 1e3:9.1f} ms/call  "
              f"(compile {compile_t:.1f}s)", flush=True)

    t0 = time.perf_counter()
    for _ in range(reps):
        state = full_step(state)
    _ = float(state.t)
    dt = (time.perf_counter() - t0) / reps
    print(f"{'full step':18s} {dt * 1e3:9.1f} ms/step  "
          f"-> {state.N / dt:,.0f} particle-steps/s", flush=True)


if __name__ == "__main__":
    main()
