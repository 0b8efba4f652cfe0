"""Sweep the gravity walk's group-chunk budget at the flagship size on
one GPU, over bench.py's measurement window.

Each argument is a log2 budget of near-field pair slots
(ops/tree.GROUP_PAIR_BUDGET), run in the order given, so that an order
such as 24 25 25 24 exposes drift.  For each, the flagship box is built
through bench.flagship_sim, bench.run_cadence takes its window, and
EXTRA more cadences are timed; every cadence prints one JSON line.

    python tools/sweep_group_chunk.py 24 25 25 24
"""

from __future__ import annotations

import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_SIDE = 100
EXTRA = 2


def main(argv) -> int:
    import jax
    import jax.monitoring

    import bench
    from chip_smoke import card_line
    from gandalf_tpu.ops import tree
    from gandalf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    bench.require_gpu(jax)
    card = card_line()
    clock = bench.CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    for log2 in (int(a) for a in argv):
        tree.GROUP_PAIR_BUDGET = 2 ** log2
        sim = bench.flagship_sim(N_SIDE)
        runs = [bench.run_cadence(sim, clock)]
        runs += [bench.run_cadence(sim, clock, warmup_cadences=0,
                                   max_cadences=1) for _ in range(EXTRA)]
        for k, res in enumerate(runs):
            print("sweep: " + json.dumps(dict(
                res, budget_log2=log2, cadence=k,
                group_chunk=sim.treespec.group_chunk, card=card)),
                flush=True)
        del sim
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
