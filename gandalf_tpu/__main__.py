"""Command-line entry point (analogue of src/Common/gandalf.cpp).

Usage:
    python -m gandalf_tpu <paramfile>        run a simulation
    python -m gandalf_tpu -r <paramfile>     restart from last snapshot

Writes column snapshots (when out_file_form = column), a `run_id.param`
record, a `run_id.timing` report and a `cont` file that is removed on a
clean finish (cluster auto-resubmit convention, gandalf.cpp:126-128).
"""

from __future__ import annotations

import os
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    restart = False
    if argv and argv[0] == "-r":
        restart = True
        argv = argv[1:]
    if len(argv) != 1:
        print("Usage: python -m gandalf_tpu [-r] <paramfile>",
              file=sys.stderr)
        return 1
    paramfile = argv[0]

    # splash (gandalf.cpp:110-123 prints a banner; keep it brief)
    print("GANDALF (JAX) v0.1 — SPH / MFV / N-body framework")

    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from .params import Parameters
    from .sim.simulation import SimulationBase

    params = Parameters()
    params.read_file(paramfile)
    run_id = params.stringparams["run_id"]

    os.environ.setdefault("GANDALF_WRITE_SNAPSHOTS", "1")
    sim = SimulationBase.factory(params)

    if restart:
        restart_file = f"{run_id}.restart"
        if not os.path.exists(restart_file):
            print(f"No restart file {restart_file}", file=sys.stderr)
            return 1
        t0 = sim.load_restart_snapshot()
        print(f"Restarting from t = {t0:.6g}")
    params.record_to_file(f"{run_id}.param")

    # 'cont' file for cluster auto-resubmission
    with open("cont", "w") as f:
        f.write(run_id + "\n")
    try:
        sim.SetupSimulation()
        sim.Run()
    finally:
        sim.timing.write(f"{run_id}.timing")
    if os.path.exists("cont"):
        os.remove("cont")
    print(f"Final t : {sim.t:.6g}     Total no. of steps : {sim.Nsteps}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
