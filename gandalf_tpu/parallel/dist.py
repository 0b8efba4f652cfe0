"""Distributed (multi-device) simulation runtime.

SPMD replacement for the reference's MPI layer (SURVEY.md §2.6;
MpiKDTreeDecomposition::CreateInitialDomainDecomposition
src/Mpi/MpiKDTreeDecomposition.cpp:56-280, ghost exchange
src/Hydrodynamics/Ghosts.cpp:161-202, dt Allreduce
src/Common/Simulation.cpp:1736-1747):

- **Domain decomposition**: particles are assigned to shards by z-slab of
  the structured grid (the analogue of the KD domain ownership; slabs give
  a 1-D ring topology so halo exchange is a single ppermute each way).
  The host-side planner sorts particles into per-shard contiguous blocks
  padded to a common capacity — the sharded state lives in this layout,
  with dead padding slots masked by `alive`.
- **Load balancing / migration**: re-planned every rebuild cadence (the
  reference migrates at tree rebuilds too); between rebuilds a drifting
  particle is clamp-binned into its shard's edge cells, which stays
  correct while per-step drift << cell size (CFL guarantees this).
- **Halo exchange**: one boundary cell layer via lax.ppermute over the
  mesh ring (parallel/halo.py machinery).
- **Distributed gravity**: positions/masses are all_gathered (the tree's
  cell summaries are cheap reductions), every shard builds the same
  implicit KD-bucket tree and walks ONLY ITS OWN group range; the
  per-shard partial accelerations are summed with psum.  Compute scales
  with the mesh; the O(N) tree build is replicated (the walk dominates).
- **Reductions**: dt via pmin, diagnostics via psum, all inside the one
  jitted step.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import sph_grid27 as g
from ..state import SphState
from .halo import make_halo_ghost_fn

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """Host-side decomposition plan (rebuilt every ntreebuildstep)."""

    n_shards: int
    cap: int                 # per-shard particle capacity (padded)
    perm: np.ndarray         # (n_shards*cap,) global slot -> original id, -1 pad
    local_spec: object       # per-shard Grid27Spec (padded row count)
    global_spec: object      # full-domain Grid27Spec
    # work-balanced decomposition (FindLoadBalancingDivision analogue,
    # reference src/Tree/HydroTree.cpp:1554): shard s owns the CONTIGUOUS
    # global rows [row_start[s], row_start[s] + row_len[s]); rows beyond
    # row_len in the padded local tensor are empty and double as the
    # receive window for the next shard's halo block.  balanced=False is
    # the uniform split (row_len all equal, the fast static-halo path).
    row_start: np.ndarray = None     # (S,) int
    row_len: np.ndarray = None       # (S,) int
    balanced: bool = False


def _balance_rows(row_w: np.ndarray, n_shards: int, min_len: int):
    """Split rows into n_shards contiguous segments minimising the max
    segment weight (the reference's FindLoadBalancingDivision bisection,
    src/Tree/HydroTree.cpp:1554-1620, as a prefix-sum linear partition).
    Every segment gets >= min_len rows.  Returns (start, length) arrays.

    Note on what 'work' means here: the dense 27-shift pair kernels cost
    the SAME on every shard by construction (identical padded tensor
    shapes) — the quantities this split actually balances are per-shard
    particle count (tree-gravity walk cost, gather/scatter cost) and the
    padded particle capacity (memory)."""
    nz = len(row_w)
    pref = np.concatenate([[0.0], np.cumsum(row_w)])
    target = pref[-1] / n_shards
    starts, start = [], 0
    for s in range(n_shards):
        rem_shards = n_shards - s - 1
        if s == n_shards - 1:
            end = nz
        else:
            # boundary at the (s+1)-th weight quantile, snapped so every
            # remaining segment keeps >= min_len rows
            end = int(np.searchsorted(pref, (s + 1) * target,
                                      side="left"))
            end = max(end, start + min_len)
            end = min(end, nz - rem_shards * min_len)
        starts.append(start)
        start = end
    starts = np.asarray(starts, np.int64)
    lens = np.diff(np.concatenate([starts, [nz]]))
    if (lens < min_len).any():
        return None, None
    return starts, lens


def plan_decomposition(spec, r: np.ndarray, n_shards: int,
                       slack: float = 1.25,
                       balance: str = "never") -> DistPlan:
    """Assign particles to z-slab shards and build the padded layout.

    balance="never": shard s covers rows [s*nz_loc, (s+1)*nz_loc)
    (uniform).  balance="auto": when the uniform split's particle-count
    imbalance exceeds 1.5x, re-split on count-weighted contiguous row
    ranges (the reference work-based load balancing,
    FindLoadBalancingDivision src/Tree/HydroTree.cpp:1554) — shards then
    own variable row ranges padded to a common tensor shape."""
    nz = spec.ncells[0]
    if nz % n_shards != 0:
        raise ValueError(
            f"grid z rows ({nz}) not divisible by n_shards ({n_shards}); "
            "build the spec with plan_grid27(..., z_multiple=n_shards) — "
            "it rounds the row count to a shard multiple for any "
            "lattice/device pair")
    nz_loc = nz // n_shards
    if any(k == 0 for (k, _side) in spec.mirror) and nz_loc < 2:
        raise ValueError(
            "mirror walls on the slab axis need >= 2 rows per shard "
            "(the wall shard must own the image layer AND its parents)")
    cell0 = spec.extents[0] / nz
    iz = np.clip(((r[:, 0] - spec.lo[0]) / cell0).astype(np.int64),
                 0, nz - 1)

    row_start = np.arange(n_shards, dtype=np.int64) * nz_loc
    row_len = np.full(n_shards, nz_loc, np.int64)
    balanced = False
    if balance == "auto" and n_shards >= 2 and not spec.mirror:
        row_counts = np.bincount(iz, minlength=nz).astype(np.float64)
        uni = np.add.reduceat(row_counts, row_start)
        mean = max(row_counts.sum() / n_shards, 1.0)
        # min segment length: the balanced halo exchange is single-hop
        # (one ring neighbour supplies the qz-row halo + pad window)
        min_len = max(spec.qz, 1)
        if uni.max() > 1.5 * mean and nz >= n_shards * min_len:
            st, ln = _balance_rows(row_counts, n_shards, min_len)
            # the dense 27-shift kernels cost nz_pad rows on EVERY shard:
            # cap the padded row count at 4x the uniform slab so hydro
            # never pays more than it saves on gravity/memory balance
            if (st is not None and ln.max() > ln.min()
                    and ln.max() <= 4 * nz_loc):
                row_start, row_len, balanced = st, ln, True

    if balanced:
        bounds = np.concatenate([row_start, [nz]])
        shard = np.searchsorted(bounds, iz, side="right") - 1
        # quantise the padded row count to slab multiples so successive
        # replans with drifting splits reuse the compiled step
        nz_pad = min(-(-int(row_len.max()) // nz_loc) * nz_loc, nz)
    else:
        shard = iz // nz_loc
        nz_pad = nz_loc
    counts = np.bincount(shard, minlength=n_shards)
    cap = int(counts.max() * slack) + 8
    # round the capacity up so dense tiles stay lane-friendly
    cap = -(-cap // 64) * 64
    order = np.argsort(shard, kind="stable")
    perm = np.full(n_shards * cap, -1, np.int64)
    start = 0
    for s in range(n_shards):
        n_s = counts[s]
        perm[s * cap: s * cap + n_s] = order[start: start + n_s]
        start += n_s
    # the local slab grid keeps the GLOBAL cell size: z extent shrinks with
    # the row count (otherwise binning would collapse the slab's rows into
    # one domain-sized cell)
    local_spec = dataclasses.replace(
        spec, ncells=(nz_pad,) + spec.ncells[1:],
        extents=(nz_pad * cell0,) + spec.extents[1:])
    return DistPlan(n_shards=n_shards, cap=cap, perm=perm,
                    local_spec=local_spec, global_spec=spec,
                    row_start=row_start, row_len=row_len,
                    balanced=balanced)


def shard_state(plan: DistPlan, s: SphState) -> SphState:
    """Re-layout the particle state into the padded shard-major order.
    Padding slots are dead (alive=False via FLAG_DEAD) with benign values."""
    from ..state import FLAG_DEAD

    idx = jnp.asarray(np.maximum(plan.perm, 0))
    pad = jnp.asarray(plan.perm < 0)

    def pick(x, fill):
        if not hasattr(x, "ndim") or x.ndim == 0 or x.shape[0] != s.N:
            return x
        out = x[idx]
        mask = pad[(...,) + (None,) * (out.ndim - 1)] if out.ndim > 1 \
            else pad
        return jnp.where(mask, jnp.asarray(fill, out.dtype), out)

    far = plan.global_spec.lo[0] + 0.5 * plan.global_spec.extents[0]
    kw = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if f.name == "flags":
            kw[f.name] = jnp.where(pad, v[idx] | FLAG_DEAD, v[idx])
        elif f.name == "iorig":
            # pads carry -1 so device-side migration can tell a free
            # padding slot from a dead-but-tracked (accreted) particle
            kw[f.name] = jnp.where(pad, -1, v[idx]).astype(v.dtype)
        elif f.name == "r":
            # pads at the domain centre of their own shard row region is
            # unnecessary — any in-domain point works since m=0, dead
            kw[f.name] = pick(v, far)
        elif f.name in ("m", "rho", "u", "u0", "pressure", "sound",
                        "dudt", "dudt0", "gpot", "zeta", "hfactor",
                        "div_v", "alpha", "ionfrac", "dt_part", "ueq"):
            kw[f.name] = pick(v, 0.0)
        elif f.name == "h":
            kw[f.name] = pick(v, 1.0)
        elif f.name == "bucket_map":
            kw[f.name] = v
        else:
            kw[f.name] = pick(v, 0)
    kw["h"] = jnp.where(pad, 1.0, kw["h"])
    return dataclasses.replace(s, **kw)


def unshard_array(plan: DistPlan, x, n_orig: int) -> np.ndarray:
    """Padded shard-major order -> original particle order (host-side;
    for per-particle arrays carried OUTSIDE the SphState, e.g. the block
    schedule's nstep_part/dt_next)."""
    inv = np.full(n_orig, 0, np.int64)
    src = plan.perm >= 0
    inv[plan.perm[src]] = np.nonzero(src)[0]
    return np.asarray(x)[inv]


def shard_array(plan: DistPlan, x, fill) -> np.ndarray:
    """Original particle order -> padded shard-major order (host-side)."""
    x = np.asarray(x)
    out = np.full((len(plan.perm),) + x.shape[1:], fill, x.dtype)
    src = plan.perm >= 0
    out[src] = x[plan.perm[src]]
    return out


def unshard_state(plan: DistPlan, s: SphState, n_orig: int) -> SphState:
    """Back to the original particle order (for snapshots/restart)."""
    inv = np.full(n_orig, 0, np.int64)
    src = plan.perm >= 0
    inv[plan.perm[src]] = np.nonzero(src)[0]
    idx = jnp.asarray(inv)

    def pick(x):
        if not hasattr(x, "ndim") or x.ndim == 0 \
                or x.shape[0] != len(plan.perm):
            return x
        return x[idx]

    kw = {f.name: pick(getattr(s, f.name)) for f in dataclasses.fields(s)}
    return dataclasses.replace(s, **kw)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), axis_names=("dp",))


def state_shardings(mesh: Mesh, s: SphState, lead_dims=None):
    """Shard every array whose leading axis is in `lead_dims` (defaults
    to the padded particle count; the LET bucket map adds its own)."""
    dims = lead_dims or {s.N}

    def rule(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] in dims:
            return NamedSharding(mesh, P("dp", *([None] * (x.ndim - 1))))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map(rule, s)


def _plan_ghost_fn(plan: DistPlan):
    """Halo ghost_fn matching the plan's decomposition flavour."""
    if plan.balanced:
        from .halo import make_halo_ghost_fn_balanced

        return make_halo_ghost_fn_balanced(
            "dp", plan.global_spec, plan.local_spec, plan.row_len)
    return make_halo_ghost_fn("dp", plan.global_spec, plan.local_spec)


def _shard_local_binning(plan: DistPlan, box, s: SphState, alive: Array):
    """Per-shard slab spec + seam-unwrapped positions + binning (shared
    by the scheme-specific sharded passes).  Runs INSIDE shard_map."""
    spec = plan.global_spec
    local = plan.local_spec
    cell0 = spec.extents[0] / spec.ncells[0]
    nz_loc = local.ncells[0]

    idx = lax.axis_index("dp")
    if plan.balanced:
        starts = jnp.asarray(plan.row_start, jnp.int32)
        lens = jnp.asarray(plan.row_len, jnp.int32)
        z0 = spec.lo[0] + starts[idx].astype(s.r.dtype) * cell0
        nz_real = lens[idx].astype(s.r.dtype)
    else:
        z0 = spec.lo[0] + idx * nz_loc * cell0
        nz_real = jnp.asarray(float(nz_loc), s.r.dtype)
    # local spec shifted to this shard's slab (binning clamps to the slab:
    # between replans a drifted particle sticks to the edge row)
    loc = dataclasses.replace(local, lo=(z0,) + local.lo[1:])

    # A particle that wraps across the periodic z seam between replans
    # would otherwise be clamp-binned to the WRONG end of this slab (its
    # wrapped z sits a whole domain away).  Min-image-unwrap z about the
    # slab centre so seam-crossers land on the correct edge row with
    # coordinates consistent with their neighbours' (pair kernels use
    # relative positions only, so a z slightly outside [lo, hi) is fine).
    r_loc = s.r
    if 0 in box.periodic_dims():
        Lz = spec.extents[0]
        zc = z0 + 0.5 * nz_real * cell0
        dz = r_loc[:, 0] - zc
        dz = dz - Lz * jnp.round(dz / Lz)
        r_loc = r_loc.at[:, 0].set(zc + dz)
    # padding slots are routed to the virtual overflow cell — they must
    # not consume fill capacity (a cap's worth of pads share one position).
    # Balanced plans clamp-bin strays to the REAL row range: pad rows
    # beyond row_len double as the halo receive window and must stay empty.
    zrow_max = (lens[idx] - 1) if plan.balanced else None
    b = g.bin_particles(loc, r_loc, discard=~alive, zrow_max=zrow_max)
    return loc, r_loc, b


def mirror_extend_state(box, spec, s, alive, vec_names=("v",)):
    """Reflected whole-set image copies of the per-particle state for the
    mirror-wall grid path (the sharded generalisation of
    ops/sph_grid27.grid_mirror_extend to ANY per-particle field set; the
    reference's mirror ghosts, src/Hydrodynamics/Ghosts.cpp:161-202 +
    src/Headers/Particle.h:601-668): one image block per wall.  Vector
    fields named in `vec_names` get their wall-normal component negated;
    every other per-particle field tiles from the parent.  Images deeper
    than one image layer (qz rows on the slab axis) are beyond kernel
    reach of every interior particle and are dropped via `keep`.
    Returns (s_ext, keep, n_rep)."""
    import dataclasses as _dc

    walls = box.mirror_walls()
    N = s.N
    r_parts, keep_parts = [s.r], [alive]
    vec_parts = {nm: [getattr(s, nm)] for nm in vec_names}
    for (k, side) in walls:
        bound = box.boxmin[k] if side == 0 else box.boxmax[k]
        layers = spec.qz if k == 0 else 1
        cell_k = spec.extents[k] / spec.ncells[k]
        rad = layers * cell_k
        r_parts.append(s.r.at[:, k].set(2.0 * bound - s.r[:, k]))
        keep_parts.append(alive & (jnp.abs(s.r[:, k] - bound) < rad))
        for nm in vec_parts:
            w = getattr(s, nm)
            vec_parts[nm].append(w.at[:, k].set(-w[:, k]))
    n_rep = 1 + len(walls)
    tile = lambda x: jnp.tile(x, (n_rep,) + (1,) * (x.ndim - 1))
    upd = {nm: jnp.concatenate(ps, axis=0) for nm, ps in vec_parts.items()}
    upd["r"] = jnp.concatenate(r_parts, axis=0)
    for f in _dc.fields(s):
        nm = f.name
        if nm in upd or nm == "bucket_map":
            continue
        x = getattr(s, nm)
        if x is not None and getattr(x, "ndim", 0) >= 1 \
                and x.shape[0] == N:
            upd[nm] = tile(x)
    return s.replace(**upd), jnp.concatenate(keep_parts, axis=0), n_rep


def _shard_mirror_binning(plan: DistPlan, box, s, alive: Array,
                          vec_names=("v",)):
    """Mirror-wall analogue of _shard_local_binning: per-shard slab spec,
    mirror-extended state (each shard extends its OWN local particles —
    a parent and its image always share a shard, so no extra
    communication; halo ppermutes carry image cells across slab seams
    like any other cells) and the extended binning.  Runs INSIDE
    shard_map.  Per-parent results come back as from_dense(...)[:N]."""
    spec, local = plan.global_spec, plan.local_spec
    cell0 = spec.extents[0] / spec.ncells[0]
    nz_loc = local.ncells[0]
    idx = lax.axis_index("dp")
    z0 = spec.lo[0] + idx * nz_loc * cell0
    loc = dataclasses.replace(local, lo=(z0,) + local.lo[1:])
    # transverse mirror walls can coexist with a periodic slab axis:
    # min-image-unwrap z about the slab centre so seam-crossers bin onto
    # the correct edge row
    r_loc = s.r
    if 0 in box.periodic_dims():
        Lz = spec.extents[0]
        zc = z0 + 0.5 * nz_loc * cell0
        dz = r_loc[:, 0] - zc
        dz = dz - Lz * jnp.round(dz / Lz)
        r_loc = r_loc.at[:, 0].set(zc + dz)
    s_ext, keep, n_rep = mirror_extend_state(box, spec,
                                             s.replace(r=r_loc), alive,
                                             vec_names)
    b = g.bin_particles(loc, s_ext.r, discard=~keep)
    return loc, s_ext, keep, b, n_rep


def _slice_parent(s_like, N: int, n_rep: int):
    """Undo mirror_extend_state on a returned state pytree: keep the
    first-N (parent) rows of every extended per-particle field."""
    import dataclasses as _dc

    upd = {}
    for f in _dc.fields(s_like):
        x = getattr(s_like, f.name)
        if x is not None and getattr(x, "ndim", 0) >= 1 \
                and x.shape[0] == n_rep * N:
            upd[f.name] = x[:N]
    return s_like.replace(**upd)


def dist_sm2012_pass(mesh: Mesh, plan: DistPlan, kern, visc,
                     gamma: float, box, h_fac: float, h_converge: float,
                     hydro_forces: bool, s: SphState, alive: Array):
    """Sharded SM2012 hydro pass: the dense 27-shift q/force kernels
    (ops/sm2012.sm2012_pass_dense) over the local slab with ppermute
    halos.  Runs INSIDE shard_map."""
    from ..ops.sm2012 import sm2012_pass_dense

    ghost = _plan_ghost_fn(plan)
    if plan.global_spec.mirror:
        loc, s_ext, keep, b, n_rep = _shard_mirror_binning(plan, box, s,
                                                           alive)
        is_parent = jnp.arange(s_ext.N) < s.N
        out = sm2012_pass_dense(kern, visc, gamma, loc, h_fac,
                                h_converge, b, s_ext, keep, hydro_forces,
                                ghost_fn=ghost,
                                count_alive=keep & is_parent,
                                n_real=s.N)
        overflow = lax.pmax(out.neib_overflow.astype(jnp.int32),
                            "dp") > 0
        out = _slice_parent(out, s.N, n_rep)
        return out.replace(r=s.r, neib_overflow=overflow)
    loc, r_loc, b = _shard_local_binning(plan, box, s, alive)
    out = sm2012_pass_dense(kern, visc, gamma, loc, h_fac, h_converge,
                            b, s.replace(r=r_loc), alive, hydro_forces,
                            ghost_fn=ghost)
    overflow = lax.pmax(out.neib_overflow.astype(jnp.int32), "dp") > 0
    return out.replace(r=s.r, neib_overflow=overflow)


def dist_cd2010_pass(plan: DistPlan, kern, visc, box,
                     s: SphState, alive: Array):
    """Sharded Cullen & Dehnen (2010) viscosity switch: dense-shift
    rr/dvw/daw accumulation over the local slab with ppermute halos
    (ops/forces.cullen_dehnen_dense).  Runs INSIDE shard_map; returns
    (alpha_new, dalphadt) in local particle order."""
    from ..ops.forces import cullen_dehnen_dense

    ghost = _plan_ghost_fn(plan)
    if plan.global_spec.mirror:
        loc, s_ext, keep, b, _ = _shard_mirror_binning(
            plan, box, s, alive, vec_names=("v", "a"))
        alpha_new, dal = cullen_dehnen_dense(
            kern, visc, loc, b, s_ext.r, s_ext.v, s_ext.a, s_ext.m,
            s_ext.h, s_ext.rho, s_ext.sound, s_ext.hfactor, s_ext.alpha,
            keep, ghost_fn=ghost)
        return alpha_new[:s.N], dal[:s.N]
    loc, r_loc, b = _shard_local_binning(plan, box, s, alive)
    return cullen_dehnen_dense(kern, visc, loc, b, r_loc, s.v, s.a,
                               s.m, s.h, s.rho, s.sound, s.hfactor,
                               s.alpha, alive, ghost_fn=ghost)


def dist_drag_pass(plan: DistPlan, kern, law, box, dt,
                   s: SphState, alive: Array, test_particle: bool):
    """Sharded gas-dust drag: the dense 27-shift drag kernels
    (ops/dust.drag_pass_dense — gather-only reformulation of the
    dust->gas energy deposit) over the local slab with ppermute halos.
    Runs INSIDE shard_map; returns a per-local-particle DragResult."""
    from ..ops.dust import drag_pass_dense

    ghost = _plan_ghost_fn(plan)
    if plan.global_spec.mirror:
        # image copies reflect v AND a/a0 (the drag kick-start velocity
        # difference uses both, Dust.cpp:52-55)
        loc, s_ext, keep, b, n_rep = _shard_mirror_binning(
            plan, box, s, alive, vec_names=("v", "a", "a0"))
        dt_r = jnp.broadcast_to(jnp.asarray(dt, s.r.dtype), (s.N,))
        res = drag_pass_dense(kern, law, loc, jnp.tile(dt_r, n_rep), b,
                              s_ext, keep, test_particle, ghost_fn=ghost)
        return type(res)(*(x[:s.N] for x in res))
    loc, r_loc, b = _shard_local_binning(plan, box, s, alive)
    return drag_pass_dense(kern, law, loc, dt, b, s.replace(r=r_loc),
                           alive, test_particle, ghost_fn=ghost)


def _dist_hydro_pass_mirror(plan: DistPlan, kern, visc, box, eos,
                            h_fac: float, h_converge: float,
                            hydro_forces: bool, s: SphState, alive: Array):
    """Mirror-wall variant of dist_hydro_pass: each shard extends its
    LOCAL particles with reflected image copies binned into the wall's
    image-cell layer (ops/sph_grid27.grid_mirror_extend; the analogue of
    the reference's mirror ghosts under MPI, src/Hydrodynamics/
    Ghosts.cpp:161-202 — here a parent and its image always share a
    shard, so no extra communication is needed; halo ppermutes carry the
    image cells across slab seams like any other cells).  Runs INSIDE
    shard_map."""
    spec = plan.global_spec
    local = plan.local_spec
    cell0 = spec.extents[0] / spec.ncells[0]
    nz_loc = local.ncells[0]
    idx = lax.axis_index("dp")
    z0 = spec.lo[0] + idx * nz_loc * cell0
    loc = dataclasses.replace(local, lo=(z0,) + local.lo[1:])
    # transverse mirror walls can coexist with a periodic slab axis:
    # min-image-unwrap z about the slab centre (same as
    # _shard_local_binning) so seam-crossers bin onto the correct edge row
    r_loc = s.r
    if 0 in box.periodic_dims():
        Lz = spec.extents[0]
        zc = z0 + 0.5 * nz_loc * cell0
        dz = r_loc[:, 0] - zc
        dz = dz - Lz * jnp.round(dz / Lz)
        r_loc = r_loc.at[:, 0].set(zc + dz)
    r_ext, v_ext, keep = g.grid_mirror_extend(box, spec, r_loc, s.v, alive)
    b = g.bin_particles(loc, r_ext, discard=~keep)

    N = s.N
    n_img = r_ext.shape[0] // N
    tile = lambda x: jnp.tile(x, (n_img,) + (1,) * (x.ndim - 1))
    hmax = g.hmax_of(spec, kern.kernrange)
    d = lambda x: g.to_dense(loc, b, x)
    fill = g.dense_fill_mask(loc, b)
    r_d = d(r_ext)
    ghost = _plan_ghost_fn(plan)
    # only PARENT slots decide overflow: edge-of-band images miss their
    # own second-layer neighbours and legitimately run past hmax
    is_parent = jnp.arange(r_ext.shape[0]) < N
    dens = g.density_grid27(kern, loc, h_fac, h_converge,
                            r_d, d(tile(s.m)), d(tile(s.h)), fill, hmax,
                            ghost_fn=ghost, count_fill=d(keep & is_parent))
    back = lambda x: g.from_dense(loc, b, x)[:N]
    live = alive
    sane = lambda x_d, v0: jnp.where(live, back(x_d), v0)
    h_new = sane(dens.h, 1.0)
    rho_new = sane(dens.rho, 1.0)
    invom_new = sane(dens.invomega, 1.0)
    zeta_new = sane(dens.zeta, 0.0)
    hfac_new = sane(dens.hfactor, 0.0)
    u_new, press_new, sound_new = eos.thermal_update(
        jnp.maximum(rho_new, 1e-30), s.u)
    u_new = jnp.where(live, u_new, 1e-30)
    press_new = jnp.where(live, press_new, 0.0)
    sound_new = jnp.where(live, sound_new, 0.0)
    if hydro_forces:
        fields = {"r": r_d, "v": d(v_ext), "m": d(tile(s.m)),
                  "h": d(tile(h_new)), "rho": d(tile(rho_new)),
                  "u": d(tile(u_new)), "pressure": d(tile(press_new)),
                  "sound": d(tile(sound_new)),
                  "invomega": d(tile(invom_new)),
                  "hfactor": d(tile(hfac_new)), "alpha": d(tile(s.alpha))}
        a_d, dudt_d, div_v_d, _ = g.forces_grid27(
            kern, visc, loc, fields, fill, ghost_fn=ghost)
        a_new = jnp.where(live[:, None], back(a_d), 0.0)
        dudt_new = sane(dudt_d, 0.0)
        div_v_new = sane(div_v_d, 0.0)
    else:
        a_new = jnp.zeros_like(s.r)
        dudt_new = jnp.zeros_like(s.m)
        div_v_new = jnp.zeros_like(s.m)
    overflow = lax.pmax((dens.overflow | b.overflow).astype(jnp.int32),
                        "dp") > 0
    return s.replace(
        h=h_new, rho=rho_new, invomega=invom_new, zeta=zeta_new,
        hfactor=hfac_new, u=u_new, pressure=press_new, sound=sound_new,
        a=a_new, dudt=dudt_new, div_v=div_v_new,
        neib_overflow=overflow)


def dist_hydro_pass(mesh: Mesh, plan: DistPlan, kern, visc, box, eos,
                    h_fac: float, h_converge: float, hydro_forces: bool,
                    s: SphState, alive: Array):
    """Sharded density+EOS+hydro-forces pass: per-shard binning/scatter
    into the local z-slab grid, ppermute halo layers, shard-local pair
    kernels.  Runs INSIDE shard_map (applied by the caller)."""
    spec = plan.global_spec
    if spec.mirror:
        return _dist_hydro_pass_mirror(plan, kern, visc, box, eos,
                                       h_fac, h_converge, hydro_forces,
                                       s, alive)
    nd = s.ndim
    loc, r_loc, b = _shard_local_binning(plan, box, s, alive)
    hmax = g.hmax_of(spec, kern.kernrange)
    d = lambda x: g.to_dense(loc, b, x)
    fill = g.dense_fill_mask(loc, b) & d(alive)
    r_d, v_d, m_d, h_d = d(r_loc), d(s.v), d(s.m), d(s.h)

    ghost = _plan_ghost_fn(plan)
    dens = g.density_grid27(kern, loc, h_fac, h_converge,
                            r_d, m_d, h_d, fill, hmax, ghost_fn=ghost)
    u_d, press_d, sound_d = eos.thermal_update(
        jnp.maximum(dens.rho, 1e-30), d(s.u))
    if hydro_forces:
        fields = {"r": r_d, "v": v_d, "m": m_d, "h": dens.h,
                  "rho": dens.rho, "u": u_d, "pressure": press_d,
                  "sound": sound_d, "invomega": dens.invomega,
                  "hfactor": dens.hfactor, "alpha": d(s.alpha)}
        a_d, dudt_d, div_v_d, _ = g.forces_grid27(
            kern, visc, loc, fields, fill, ghost_fn=ghost)
    else:
        a_d = jnp.zeros_like(r_d)
        dudt_d = jnp.zeros_like(m_d)
        div_v_d = jnp.zeros_like(m_d)

    back = lambda x: g.from_dense(loc, b, x)
    live = alive
    sane = lambda x_d, v0: jnp.where(live, back(x_d), v0)
    overflow = lax.pmax((dens.overflow | b.overflow).astype(jnp.int32),
                        "dp") > 0
    return s.replace(
        h=sane(dens.h, 1.0), rho=sane(dens.rho, 1.0),
        invomega=sane(dens.invomega, 1.0), zeta=sane(dens.zeta, 0.0),
        hfactor=sane(dens.hfactor, 0.0), u=sane(u_d, 1e-30),
        pressure=sane(press_d, 0.0), sound=sane(sound_d, 0.0),
        a=jnp.where(live[:, None], back(a_d), 0.0),
        dudt=sane(dudt_d, 0.0), div_v=sane(div_v_d, 0.0),
        neib_overflow=overflow)


def dist_levelneib_pass(plan: DistPlan, kern, box, s: SphState,
                        alive: Array) -> Array:
    """Sharded max-neighbour-timestep-level pass (the levelneib
    accumulation the reference does inside its force loops,
    GradhSph.cpp:461, exchanged over MPI ghosts): dense 27-shift
    max-reduction over the local slab with ppermute halos.  Runs INSIDE
    shard_map; returns levelneib in local particle order."""
    ghost = _plan_ghost_fn(plan)
    if plan.global_spec.mirror:
        # image copies carry the PARENT's level (a neighbour pair that
        # interacts only through a wall image still syncs levels)
        loc, s_ext, keep, b, _ = _shard_mirror_binning(plan, box, s,
                                                       alive)
        lvl = _levelneib_body(kern, loc, b, ghost, s_ext.r, s_ext.h,
                              s_ext.level, keep)
        return jnp.where(alive, lvl[:s.N], s.levelneib)
    loc, r_loc, b = _shard_local_binning(plan, box, s, alive)
    lvl = _levelneib_body(kern, loc, b, ghost, r_loc, s.h, s.level,
                          alive)
    return jnp.where(alive, lvl, s.levelneib)


def _levelneib_body(kern, loc, b, ghost, r_use: Array, h: Array,
                    level: Array, mask: Array) -> Array:
    """Dense 27-shift max-neighbour-level reduction (shared by the plain
    and mirror-extended levelneib passes)."""
    nd = r_use.shape[1]
    d = lambda x: g.to_dense(loc, b, x)
    back = lambda x: g.from_dense(loc, b, x)
    fill = g.dense_fill_mask(loc, b) & d(mask)
    K = loc.k_cell
    r_d = d(r_use)
    # packed per-neighbour channels: [h, level (as float)]
    pk = jnp.stack([d(h), d(level).astype(r_d.dtype)], axis=-1)
    rp = ghost(loc, r_d, shift_vec=True)
    pkp = ghost(loc, pk)
    fp_ = ghost(loc, fill)

    flat = lambda x: x.reshape((-1,) + x.shape[nd + 1:])
    Np = int(np.prod(loc.ncells)) * K
    h_f = flat(d(h))
    kr2 = kern.kernrange * kern.kernrange
    lvl_max = jnp.zeros((Np,), jnp.int32)
    for sh in g._shifts(nd, loc.qz):
        r_nb = g._shift_view(loc, rp, sh)
        pk_nb = g._shift_view(loc, pkp, sh)
        f_nb = g._shift_view(loc, fp_, sh)
        dr = (r_nb[..., None, :, :]
              - r_d[..., :, None, :]).reshape(Np, K, nd)
        drsqd = jnp.sum(dr * dr, axis=-1)
        pkb = jnp.broadcast_to(
            pk_nb[..., None, :, :],
            pk_nb.shape[:nd] + (K,) + pk_nb.shape[nd:]).reshape(Np, K, 2)
        ok = jnp.broadcast_to(
            f_nb[..., None, :],
            f_nb.shape[:nd] + (K, K)).reshape(Np, K)
        hm = jnp.maximum(h_f[:, None], pkb[..., 0])
        near = ok & (drsqd <= kr2 * hm * hm)
        lvl_max = jnp.maximum(
            lvl_max, jnp.max(jnp.where(near, pkb[..., 1], -1.0), axis=-1)
            .astype(jnp.int32))
    lvl_max = jnp.maximum(lvl_max, 0)
    shp = loc.ncells + (K,)
    return back(lvl_max.reshape(shp))


def dist_tree_gravity(treespec, bucket_map: Array, s: SphState,
                      kern, alive: Array, n_shards: int,
                      periodic_extent=None, ewald_table=None,
                      zeta_scaling: str = "sph"):
    """Distributed Barnes-Hut gravity inside shard_map: all_gather the
    (r, m, h, zh) source arrays, build the replicated implicit tree, walk
    only this shard's contiguous group range, and psum the partial
    accelerations (the analogue of the reference's pruned-tree remote
    multipoles + export/return force sums, HydroTree.cpp:777-1238)."""
    from ..ops.tree import build_tree, tree_gravity

    # gather the full particle set (tiled over shards)
    r_all = lax.all_gather(s.r, "dp", tiled=True)
    m_all = lax.all_gather(jnp.where(alive, s.m, 0.0), "dp", tiled=True)
    h_all = lax.all_gather(s.h, "dp", tiled=True)
    zh_all = lax.all_gather(s.zeta * s.hfactor, "dp", tiled=True)
    alive_all = lax.all_gather(alive, "dp", tiled=True)

    flat = bucket_map.reshape(-1)
    safe = jnp.maximum(flat, 0)
    in_map = flat >= 0
    r_s = jnp.where(in_map[:, None], r_all[safe], 1e15)
    if periodic_extent is not None:
        from ..ops.tree import unwrap_to_buckets

        r_s = unwrap_to_buckets(treespec, r_s, in_map, periodic_extent)
    m_s = jnp.where(in_map, m_all[safe], 0.0)
    alive_s = in_map & alive_all[safe]
    h_s = jnp.where(in_map, h_all[safe], 1.0)
    zh_s = jnp.where(in_map, zh_all[safe], 0.0)
    tree = build_tree(treespec, r_s, m_s, alive_s)

    # walk only this shard's group range
    G = treespec.n_leaves
    G_loc = G // n_shards
    idx = lax.axis_index("dp")
    g0 = idx * G_loc
    res, overflow = tree_gravity(
        treespec, tree, r_s, m_s, alive_s, h_s, kern, zh_s,
        group_range=(g0, G_loc), ewald_table=ewald_table,
        ewald_extent=periodic_extent if ewald_table is not None
        else None, zeta_scaling=zeta_scaling)

    # scatter local groups' results into the global array and sum
    N_tot = r_all.shape[0]
    ids = lax.dynamic_slice_in_dim(flat, g0 * treespec.leaf_size,
                                   G_loc * treespec.leaf_size)
    ok = ids >= 0
    sids = jnp.maximum(ids, 0)
    a_glob = jnp.zeros((N_tot, r_all.shape[1]), r_all.dtype)
    a_glob = a_glob.at[sids].add(jnp.where(ok[:, None], res.a, 0.0))
    gp_glob = jnp.zeros((N_tot,), r_all.dtype)
    gp_glob = gp_glob.at[sids].add(jnp.where(ok, res.gpot, 0.0))
    a_glob = lax.psum(a_glob, "dp")
    gp_glob = lax.psum(gp_glob, "dp")
    overflow = lax.pmax(overflow.astype(jnp.int32), "dp") > 0

    # slice out this shard's particles (leading-axis shard layout)
    cap = s.N  # inside shard_map, s.N is the LOCAL block length
    p0 = idx * cap
    a_loc = lax.dynamic_slice_in_dim(a_glob, p0, cap)
    gp_loc = lax.dynamic_slice_in_dim(gp_glob, p0, cap)
    return a_loc, gp_loc, overflow


# -- distributed meshless finite-volume passes ---------------------------
def _mfv_mirror_tensors(box, s, s_ext):
    """Per-wall tensor reflections for the mirror-extended MfvState
    (matches sim/mfv_sim._mirror_tensor_images; reference reflect()
    helpers, src/Headers/Particle.h:601-668): under the wall-k
    reflection R (identity with R_kk = -1), B -> R B R^T and the
    primitive-gradient matrix grad -> S grad R^T with S flipping the
    v_k row.  mirror_extend_state already reflected r/v/a0 and tiled
    everything else; only B and grad need the matrix fix-up."""
    nd = s.ndim
    Bs, grads = [s.B], [s.grad]
    for (k, _side) in box.mirror_walls():
        sign = jnp.ones((nd,), s.B.dtype).at[k].set(-1.0)
        row = jnp.concatenate([sign, jnp.ones((2,), s.B.dtype)])
        Bs.append(s.B * sign[None, :, None] * sign[None, None, :])
        grads.append(s.grad * row[None, :, None] * sign[None, None, :])
    return s_ext.replace(B=jnp.concatenate(Bs, axis=0),
                         grad=jnp.concatenate(grads, axis=0))


def _dist_mfv_binning(plan: DistPlan, box, s, alive: Array):
    """MFV variant of _shard_local_binning (duck-typed on .r) plus the
    dense/back converters and halo ghost fn shared by the three MFV
    passes.  Runs INSIDE shard_map.

    Returns (loc, s_use, b, ghost, d, back, fill): s_use is the state
    whose per-particle fields feed the dense kernels — under mirror
    walls it is the image-extended state (each shard extends its OWN
    local particles; `back` then slices the parent rows), otherwise the
    input state with slab-unwrapped coordinates."""
    ghost = _plan_ghost_fn(plan)
    if plan.global_spec.mirror:
        loc, s_ext, keep, b, _ = _shard_mirror_binning(
            plan, box, s, alive, vec_names=("v", "a0"))
        s_ext = _mfv_mirror_tensors(box, s, s_ext)
        d = lambda x: g.to_dense(loc, b, x)
        back = lambda x: g.from_dense(loc, b, x)[: s.N]
        fill = g.dense_fill_mask(loc, b) & d(keep)
        # parent rows only decide overflow (edge-of-band images miss
        # their own second-layer neighbours and run h past hmax)
        cfill = fill & d(keep & (jnp.arange(s_ext.N) < s.N))
        return loc, s_ext, b, ghost, d, back, fill, cfill
    loc, r_loc, b = _shard_local_binning(plan, box, s, alive)
    d = lambda x: g.to_dense(loc, b, x)
    back = lambda x: g.from_dense(loc, b, x)
    fill = g.dense_fill_mask(loc, b) & d(alive)
    return loc, s.replace(r=r_loc), b, ghost, d, back, fill, fill


def dist_mfv_density_pass(plan: DistPlan, kern, box, h_fac: float,
                          h_converge: float, eos, s, alive: Array):
    """Sharded MFV number-density/h pass + EOS refresh
    (MeshlessFVTree::UpdateAllProperties over MPI ghosts).  Runs INSIDE
    shard_map."""
    from ..ops.mfv_grid27 import density_mfv_grid27

    loc, su, b, ghost, d, back, fill, cfill = _dist_mfv_binning(
        plan, box, s, alive)
    hmax = g.hmax_of(plan.global_spec, kern.kernrange)
    dens = density_mfv_grid27(kern, loc, h_fac, h_converge, d(su.r),
                              d(su.m), d(su.h), fill, hmax,
                              ghost_fn=ghost, count_fill=cfill)
    sane = lambda x, v0: jnp.where(alive, back(x), v0)
    rho = sane(dens.rho, 1.0)
    u, pressure, sound = eos.thermal_update(jnp.maximum(rho, 1e-30), s.u)
    overflow = lax.pmax((dens.overflow | b.overflow).astype(jnp.int32),
                        "dp") > 0
    return s.replace(
        h=sane(dens.h, 1.0), ndens=sane(dens.ndens, 1.0), rho=rho,
        invomega=sane(dens.invomega, 1.0), zeta=sane(dens.zeta, 0.0),
        hfactor=sane(dens.hfactor, 0.0),
        u=jnp.where(alive, u, 0.0),
        pressure=jnp.where(alive, pressure, 0.0),
        sound=jnp.where(alive, sound, 0.0),
        neib_overflow=s.neib_overflow | overflow)


def dist_mfv_gradient_pass(plan: DistPlan, kern, box, s, alive: Array,
                           limiter: str = "scalar"):
    """Sharded MFV least-squares gradients + slope limiter
    (MeshlessFVTree::UpdateGradientMatrices).  Runs INSIDE shard_map."""
    from ..ops.mfv_grid27 import gradients_mfv_grid27

    loc, su, b, ghost, d, back, fill, _cf = _dist_mfv_binning(
        plan, box, s, alive)
    dense = {"r": d(su.r), "h": d(su.h), "ndens": d(su.ndens),
             "Wprim": d(su.Wprim), "sound": d(su.sound)}
    res = gradients_mfv_grid27(kern, loc, dense, fill, ghost_fn=ghost,
                               limiter=limiter)
    sane = lambda x, v0: jnp.where(alive, back(x), v0)
    B = back(res.B)
    grad = back(res.grad)
    alpha = back(res.alpha_slope)
    overflow = lax.pmax(b.overflow.astype(jnp.int32), "dp") > 0
    return s.replace(
        B=jnp.where(alive[:, None, None], B, 0.0),
        grad=jnp.where(alive[:, None, None], grad, 0.0),
        alpha_slope=jnp.where(alive[:, None], alpha, 0.0),
        vsig_max=sane(res.vsig_max, 1.0),
        bad_grad=jnp.where(alive, back(res.bad).astype(s.h.dtype), 1.0),
        neib_overflow=s.neib_overflow | overflow)


def dist_mfv_flux_pass(plan: DistPlan, kern, cfg, box, dt, s,
                       alive: Array, block=None):
    """Sharded MUSCL Godunov flux accumulation
    (MeshlessFVTree::UpdateGodunovFluxes).  Runs INSIDE shard_map;
    returns a FluxResult in local particle order.

    Block-timestep mode: `block` carries (start, dt_own) per local
    particle; the packed neighbour tensor then also ships dt_own/start
    through the halo ppermutes, so dt_pair = min(dt_i, dt_j) is exact
    across slab seams (the reference exchanges part.dt on its MPI
    ghosts).  Mirror images inherit the parent's start/dt_own."""
    from ..ops.mfv import FluxResult
    from ..ops.mfv_grid27 import fluxes_mfv_grid27

    loc, su, b, ghost, d, back, fill, _cf = _dist_mfv_binning(
        plan, box, s, alive)
    dense = {"r": d(su.r), "h": d(su.h), "ndens": d(su.ndens),
             "hfactor": d(su.hfactor), "Wprim": d(su.Wprim),
             "sound": d(su.sound), "a0": d(su.a0), "B": d(su.B),
             "grad": d(su.grad), "alpha_slope": d(su.alpha_slope),
             "bad": d(su.bad_grad.astype(s.h.dtype))}
    if block is not None:
        start, dt_own = block
        n_rep = su.N // s.N
        if n_rep > 1:
            start = jnp.tile(start, (n_rep,))
            dt_own = jnp.tile(dt_own, (n_rep,))
        dense["dt_own"] = d(dt_own)
        dense["start"] = d(start.astype(s.h.dtype))
    res = fluxes_mfv_grid27(kern, cfg, loc, dt, dense, fill,
                            ghost_fn=ghost)
    dQdt = jnp.where(alive[:, None], back(res.dQdt), 0.0)
    rdmdt = jnp.where(alive[:, None], back(res.rdmdt_dot), 0.0)
    if block is not None:
        return FluxResult(
            dQdt=dQdt, rdmdt_dot=rdmdt,
            dQ=jnp.where(alive[:, None], back(res.dQ), 0.0),
            rdmdt=jnp.where(alive[:, None], back(res.rdmdt), 0.0))
    return FluxResult(dQdt=dQdt, rdmdt_dot=rdmdt)


def dist_mfv_vsig_pass(plan: DistPlan, kern, box, s, alive: Array):
    """Sharded conservative distant-signal-velocity bound
    (Tree::ComputeSignalVelocityFromDistantInteractions,
    src/Tree/Tree.cpp:891-1040): the near field is exact over the local
    slab's shift neighbourhood (halo ppermutes supply seam cells); the
    far field uses the global O(C^2) cell-aggregate bound — the per-cell
    aggregates (4 scalars + 2 vectors per cell) are all_gathered and
    every shard evaluates its own rows of the global geometry.  Mirror
    images are excluded, matching the single-chip walk.  Runs INSIDE
    shard_map; returns the per-local-particle vsig bound."""
    from ..ops.mfv_grid27 import (vsig_cell_aggregates, vsig_far_from_agg,
                                  vsig_near_grid27)

    loc, r_loc, b = _shard_local_binning(plan, box, s, alive)
    ghost = _plan_ghost_fn(plan)
    d = lambda x: g.to_dense(loc, b, x)
    back = lambda x: g.from_dense(loc, b, x)
    fill = g.dense_fill_mask(loc, b) & d(alive)
    dense = {"r": d(r_loc), "v": d(s.v), "sound": d(s.sound),
             "h": d(s.h)}
    near = back(vsig_near_grid27(loc, dense, fill, ghost_fn=ghost))

    gs = plan.global_spec
    rest = 1
    for n in gs.ncells[1:]:
        rest *= n
    aggs = vsig_cell_aggregates(loc, dense, fill)
    gathered = [lax.all_gather(x, "dp") for x in aggs]

    def to_global(x_all):
        # concatenate each shard's REAL rows (row_len is host-static)
        rows = [x_all[si, : int(plan.row_len[si]) * rest]
                for si in range(plan.n_shards)]
        return jnp.concatenate(rows, axis=0)

    ms_g, occ_g, vmax_g, vmin_g = [to_global(x) for x in gathered]
    A, Bc = vsig_far_from_agg(gs, ms_g, occ_g, vmax_g, vmin_g)
    idx = lax.axis_index("dp")
    starts = jnp.asarray(plan.row_start, jnp.int32)
    cell_of = jnp.clip(b.cell_of, 0, loc.total_cells - 1)
    gcell = cell_of + starts[idx] * rest
    far = s.h * jnp.maximum(s.sound * A[gcell] + Bc[gcell], 0.0)
    return jnp.maximum(near, far)


# ---------------------------------------------------------------------------
# Device-side particle migration (the reference's Alltoallv,
# src/Mpi/MpiControl.cpp:1073-1150 SendReceiveParticles)
# ---------------------------------------------------------------------------

def migrate_particles(plan: DistPlan, s: SphState, extra: tuple = (),
                      mig_cap: int = None):
    """Move particles that drifted out of their owner z-slab to the owning
    shard with ONE lax.all_to_all — no host round-trip.  Runs INSIDE
    shard_map over axis "dp" on the (cap, ...) local blocks.

    `extra` is a tuple of additional per-particle (cap,) arrays that
    migrate with the particles (the block schedule's nstep_part/dt_next).
    Returns (state', extra', overflow): overflow is True when a shard had
    more than mig_cap out-migrants to one destination or more arrivals
    than free (dead) slots — callers fall back to the host replan.

    The exchange ships every (cap, ...) leaf of the state as a (S, M, ...)
    buffer; M = mig_cap is a static shape, so the step never recompiles
    for migration (the reference sizes its MPI send buffers dynamically,
    MpiControl.cpp:1090-1110; fixed capacity + overflow flag is the
    XLA-static equivalent)."""
    from ..state import FLAG_DEAD

    gs = plan.global_spec
    nz = gs.ncells[0]
    nz_loc = plan.local_spec.ncells[0]
    cap = plan.cap
    S = plan.n_shards
    M = mig_cap or max(64, cap // 16)
    M = min(M, cap)

    me = lax.axis_index("dp")
    alive = s.alive
    cell0 = gs.extents[0] / nz
    iz = jnp.clip(jnp.floor((s.r[:, 0] - gs.lo[0]) / cell0), 0, nz - 1
                  ).astype(jnp.int32)
    if plan.balanced:
        bounds = jnp.asarray(
            np.concatenate([plan.row_start, [nz]]), jnp.int32)
        dest = jnp.clip(jnp.searchsorted(bounds, iz, side="right") - 1,
                        0, S - 1).astype(jnp.int32)
    else:
        dest = jnp.clip(iz // nz_loc, 0, S - 1)
    leave = alive & (dest != me)

    # ---- pack out-migrants into per-destination buckets ------------------
    sort_key = jnp.where(leave, dest, S)          # stayers sort last
    order = jnp.argsort(sort_key)                  # leavers grouped by dest
    cnt = jnp.zeros((S,), jnp.int32).at[dest].add(
        leave.astype(jnp.int32))
    off = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                           jnp.cumsum(cnt)[:-1].astype(jnp.int32)])
    mth = jnp.arange(M, dtype=jnp.int32)
    gpos = off[:, None] + mth[None, :]
    valid_send = mth[None, :] < cnt[:, None]       # (S, M)
    idx_send = jnp.where(valid_send,
                         order[jnp.clip(gpos, 0, cap - 1)], 0)
    over_out = jnp.max(cnt) > M

    a2a = lambda x: lax.all_to_all(x, "dp", split_axis=0, concat_axis=0)
    valid_recv = a2a(valid_send)                   # (S, M) arrivals to me
    arr_valid = valid_recv.reshape(-1)             # (S*M,)

    # ---- local compaction bookkeeping ------------------------------------
    # free slots are TRUE padding (iorig < 0) and the leavers' vacated
    # slots — NOT dead-but-tracked records (accreted particles keep their
    # slot so snapshots can restore the original particle order)
    free = leave | (s.iorig < 0)
    free_ids = jnp.argsort(~free)                  # free slots first
    n_free = jnp.sum(free.astype(jnp.int32))
    arr_order = jnp.argsort(~arr_valid)            # valid arrivals first
    n_arr = jnp.sum(arr_valid.astype(jnp.int32))
    k = jnp.arange(S * M, dtype=jnp.int32)
    place_ok = (k < n_arr) & (k < n_free)
    target = jnp.where(place_ok, free_ids[jnp.clip(k, 0, cap - 1)], cap)
    over_in = n_arr > n_free
    overflow = over_out | over_in

    def move(x, local_base=None):
        if not hasattr(x, "ndim") or x.ndim == 0 or x.shape[0] != cap:
            return x
        buf = a2a(x[idx_send])                     # (S, M, ...)
        arr = buf.reshape((S * M,) + x.shape[1:])[arr_order]
        base = x if local_base is None else local_base
        return base.at[target].set(arr, mode="drop")

    kw = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if f.name == "bucket_map":
            kw[f.name] = v
            continue
        if f.name == "flags":
            # send the PRE-kill flags (arrivals must be alive); leavers
            # die in the local base before arrivals are placed
            kw[f.name] = move(v, jnp.where(leave, v | FLAG_DEAD, v))
            continue
        if f.name == "iorig":
            # vacated slots become true padding (-1) so future
            # migrations and perm_from_iorig treat them as free
            kw[f.name] = move(v, jnp.where(leave, -1, v).astype(v.dtype))
            continue
        kw[f.name] = move(v)
    out_extra = tuple(move(x) for x in extra)
    s2 = dataclasses.replace(s, **kw)
    # arrivals' flags came from the sender pre-kill (alive); slots beyond
    # n_arr keep their dead padding
    return s2, out_extra, overflow


def perm_from_iorig(plan: DistPlan, iorig_sharded) -> DistPlan:
    """Rebuild the host-side slot -> original-id permutation from the
    device state's iorig after device-side migrations moved particles
    out from under `plan.perm` (called lazily, only when the host
    actually needs original order: snapshots, restarts, full replans)."""
    perm = np.asarray(iorig_sharded).astype(np.int64).ravel()
    return dataclasses.replace(plan, perm=np.where(perm >= 0, perm, -1))
