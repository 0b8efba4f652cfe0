"""Listed-walk gravity ablation profiler: splits tree_gravity_listed's
cost into stock (build_tree from live positions), far field (multipole
list evaluation) and near field (leaf pair block + support tier) by
timing width-ablated variants on the GPU — the list widths are
SHAPES, so slicing a list to width 0 removes that tier's compute.

    BENCH_NSIDE=100 python tools/profile_listed.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

# the listed walk is opt-in since the frontier walk became the default
os.environ.setdefault("GANDALF_TREE_WALK", "listed")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from gandalf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bench import build_sim, jitter_box
    from gandalf_tpu.ops.tree import build_tree, tree_gravity_listed
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
    spec = sim.treespec
    assert state.walk_mp is not None, "listed walk not planned"
    Wm = state.walk_mp.shape[1]
    Wn = state.walk_near.shape[1]
    print(f"N={state.N} L={spec.leaf_size} Wm={Wm} Wn={Wn} "
          f"Ws={spec.support_cap} quad={spec.quadrupole}", flush=True)

    def timed(name, fn):
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
        print(f"{name:22s} {dt * 1e3:9.1f} ms  (compile {compile_t:.1f}s)",
              flush=True)
        return dt

    # match the production call exactly (ADVICE r4): the step passes the
    # box's periodic extent, whose per-step bucket unwrap is part of the
    # measured cost
    pdims = sim.box.periodic_dims()
    pext = [sim.box.size[k] if k in pdims else 0.0
            for k in range(sim.ndim)] if pdims else None

    def listed(s, mp_w, near_w, with_h=True):
        a, gpot, ovf = tree_gravity_listed(
            spec, s.bucket_map, s.walk_mp[:, :mp_w], s.walk_near[:, :near_w],
            s.walk_plan_r, s.walk_anchors, s.walk_margin, s.r, s.m,
            s.h if with_h else None, sim.kern if with_h else None,
            alive=s.alive, zh=(s.zeta * s.hfactor) if with_h else None,
            periodic_extent=pext)
        return a.sum() + gpot.sum()

    def stock_only(s):
        flat = s.bucket_map.reshape(-1)
        safe = jnp.maximum(flat, 0)
        in_map = flat >= 0
        r_s = jnp.where(in_map[:, None], s.r[safe], 1e15)
        m_s = jnp.where(in_map, s.m[safe], 0.0)
        tree = build_tree(spec, r_s, m_s, in_map & s.alive[safe])
        return sum(t.sum() for t in tree.m) + sum(t.sum() for t in tree.com)

    # ablated widths are 1 (not 0): the list shapes must stay non-empty,
    # so each "only" variant still carries a 1-wide residual of the other
    # tier — the derived split below is an approximation good to ~1/W
    t_full = timed("full listed", lambda s: listed(s, Wm, Wn))
    t_stock = timed("stock only", stock_only)
    t_mp = timed("mp only (near w=1)", lambda s: listed(s, Wm, 1, False))
    t_near = timed("near only (mp w=1)", lambda s: listed(s, 1, Wn))
    t_near_nosup = timed("near, no support", lambda s: listed(s, 1, Wn,
                                                              False))
    print(f"derived (approx, width-1 residuals): "
          f"far~{(t_mp - t_stock) * 1e3:.0f}ms "
          f"near~{(t_near_nosup - t_stock) * 1e3:.0f}ms "
          f"support~{(t_near - t_near_nosup) * 1e3:.0f}ms "
          f"stock~{t_stock * 1e3:.0f}ms", flush=True)


if __name__ == "__main__":
    main()
