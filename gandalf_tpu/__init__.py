"""gandalf_tpu: a JAX SPH + Meshless-FV + N-body astrophysics framework.

A ground-up JAX/XLA re-design of the capabilities of GANDALF
(Graphical Astrophysics code for N-body Dynamics And Lagrangian Fluids,
reference: /root/reference, Hubber, Rosotti & Booth 2018):

- grad-h SPH, Saitoh-Makino 2012 SPH, and Gizmo-style meshless finite-volume
  hydrodynamics (reference layer map: SURVEY.md §1),
- self-gravity via Barnes-Hut style tree multipoles and direct N-body
  (Hermite4 / leapfrog integrators),
- structured-array (SoA) particle state as JAX pytrees, fixed-capacity
  padded neighbour lists, `lax.while_loop` h-rho iterations,
- multi-device scaling through `jax.sharding.Mesh` + `shard_map` with XLA
  collectives instead of MPI (reference: src/Mpi/*).

Precision: GANDALF defaults to double precision (reference Makefile:27).
Set environment variable ``GANDALF_PRECISION=double`` (or call
:func:`enable_x64` before any JAX computation) to run regression-grade
float64.  The throughput path uses float32.
"""

import os

__version__ = "0.1.0"


def enable_x64() -> None:
    """Enable float64 in JAX (must run before any trace)."""
    import jax

    jax.config.update("jax_enable_x64", True)


if os.environ.get("GANDALF_PRECISION", "").lower() in ("double", "x64", "float64"):
    enable_x64()

from .params import Parameters  # noqa: E402,F401
