"""Tree-gravity variant profiler: splits the walk's cost into far-field
(frontier multipole), near-field (leaf pair block), and smoothed-support
tiers by timing ablated variants on the GPU.

    BENCH_NSIDE=64 python tools/profile_tree.py
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

    import dataclasses

    from bench import build_sim, jitter_box
    from gandalf_tpu.ops.tree import tree_gravity_grouped
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
    # converge h/rho once so zeta is realistic
    sim._compile()
    state = jax.jit(sim._build_bootstrap())(sim.state)
    spec = sim.treespec
    print(f"N={state.N} spec: L={spec.leaf_size} depth={spec.depth} "
          f"W={spec.frontier} Wn={spec.near_cap} Ws={spec.support_cap} "
          f"Gc={spec.group_chunk} quad={spec.quadrupole} fast={spec.fast}",
          flush=True)

    def run(name, spec_v, with_h=True, with_zh=True):
        def fn(s):
            a, gpot, ovf = tree_gravity_grouped(
                spec_v, s.bucket_map, s.r, s.m,
                s.h if with_h else None, sim.kern if with_h else None,
                alive=s.alive,
                zh=(s.zeta * s.hfactor) if (with_h and with_zh) else None)
            return a.sum() + gpot.sum()
        jf = jax.jit(fn)
        t0 = time.perf_counter()
        v = jf(state)
        jax.block_until_ready(v)
        compile_t = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            v = jf(state)
        jax.block_until_ready(v)
        dt = (time.perf_counter() - t0) / reps
        print(f"{name:34s} {dt * 1e3:9.1f} ms  (compile {compile_t:.1f}s)",
              flush=True)
        return dt

    import json
    names = os.environ.get(
        "PROFILE_VARIANTS",
        "base,near4,front2,near4front2").split(",")
    variants = {
        "base": (spec, True),
        "nosup": (spec, False),
        "near2": (dataclasses.replace(spec, near_cap=spec.near_cap // 2),
                  False),
        "near4": (dataclasses.replace(spec, near_cap=spec.near_cap // 4),
                  False),
        "front2": (dataclasses.replace(spec, frontier=spec.frontier // 2),
                   False),
        "near4front2": (dataclasses.replace(
            spec, near_cap=spec.near_cap // 4,
            frontier=spec.frontier // 2), False),
        "gc256": (dataclasses.replace(spec, group_chunk=256), False),
        "gc512": (dataclasses.replace(spec, group_chunk=512), False),
        "gc1024": (dataclasses.replace(spec, group_chunk=1024), False),
        "gc64": (dataclasses.replace(spec, group_chunk=64), False),
        "gc32": (dataclasses.replace(spec, group_chunk=32), False),
        "gc16": (dataclasses.replace(spec, group_chunk=16), False),
        "L0mac": (dataclasses.replace(spec, mac="geometric"), True),
    }
    out = {}
    for nm in names:
        sp, wh = variants[nm]
        out[nm] = run(nm, sp, with_h=wh)
    print(json.dumps({k: round(v * 1e3, 1) for k, v in out.items()}),
          flush=True)


if __name__ == "__main__":
    main()
