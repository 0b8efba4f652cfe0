"""Structured 27-shift SPH pipeline: zero gathers in the hot loop.

A dense formulation of the neighbour problem:

1. particles are binned to a uniform grid and scattered into dense per-cell
   storage shaped (nz, ny, nx, K, ...) (K = padded slots per cell),
2. one layer of GHOST CELLS is added around the grid — wrap-copied for
   periodic dimensions, empty for open ones — so that
3. every neighbour access in the hot loops is a STATIC slice of the ghosted
   tensor: the 3^ndim adjacent cells of all cells at once are
   `padded[1+dz : 1+dz+nz, 1+dy : 1+dy+ny, 1+dx : 1+dx+nx]` for the 27
   (dz, dy, dx) offsets.  No argsort-order gathers, no scatter in the pair
   loop — XLA fuses each shift's pair block into one loop nest.

This mirrors how the reference bounds its working set with per-cell
neighbour buffers (SURVEY.md §5 'long-context analogue'); the structured
grid replaces the KD-tree walk entirely for near-uniform h.  Gravity and
strongly-adaptive h go through the tree (ops.tree).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.smoothing import SmoothingKernel
from ..state import DomainBox, SphState
from .forces import ArtificialViscosity

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class Grid27Spec:
    """Static grid geometry. ncells excludes ghost layers.

    qz: shift radius along dim 0.  Normally 1 (cells >= kernel support,
    27 shifts).  The distributed z-slab planner may choose z cells SMALLER
    than the support (so every shard owns >= 1 row); then qz =
    ceil(support / cell_z) and the neighbour search scans (2*qz+1)*3^(nd-1)
    shifts with qz ghost layers on dim 0."""

    ndim: int
    ncells: Tuple[int, ...]        # (nz, ny, nx) order = (dim0, dim1, ...)
    lo: Tuple[float, ...]
    extents: Tuple[float, ...]
    k_cell: int
    periodic: Tuple[bool, ...]
    qz: int = 1
    # mirror/wall boundaries (dim, side) with a dedicated image-cell layer
    # beyond the wall (reference mirror ghosts, GhostNeighbours.hpp):
    # ncells/lo/extents above INCLUDE those image layers
    mirror: Tuple[Tuple[int, int], ...] = ()

    @property
    def total_cells(self) -> int:
        return int(np.prod(self.ncells))


def hmax_of(spec: Grid27Spec, kernrange: float) -> float:
    """Largest h whose kernel support the shift stencil still covers."""
    reach = [spec.qz * spec.extents[0] / spec.ncells[0]]
    reach += [spec.extents[k] / spec.ncells[k]
              for k in range(1, spec.ndim)]
    return min(reach) / kernrange


def plan_grid27(box: DomainBox, r: np.ndarray, h_max: float,
                kernrange: float, k_slack: float = 1.35,
                z_multiple: int = 1) -> Grid27Spec:
    """Host-side planning (per rebuild cadence): cells as small as the
    kernel support allows, k_cell slots sized from the fullest cell."""
    r = np.asarray(r)
    ndim = r.shape[1]
    support = float(kernrange * h_max)
    pdims = box.periodic_dims()
    walls = box.mirror_walls()
    mlo = [False] * ndim
    mhi = [False] * ndim
    for (k, side) in walls:
        if side == 0:
            mlo[k] = True
        else:
            mhi[k] = True
    lo, hi, periodic = [], [], []
    for k in range(ndim):
        if k in pdims:
            lo_k, hi_k = box.boxmin[k], box.boxmax[k]
            periodic.append(True)
        else:
            # mirror/wall sides anchor the grid at the reflection plane so
            # the image-cell layer added below sits exactly beyond the wall
            lo_k = box.boxmin[k] if mlo[k] else float(r[:, k].min()) - 1e-6
            hi_k = box.boxmax[k] if mhi[k] else float(r[:, k].max()) + 1e-6
            periodic.append(False)
        lo.append(lo_k)
        hi.append(hi_k)
    ncells = [max(int(np.floor((hi[k] - lo[k]) / support)), 1)
              for k in range(ndim)]
    e0 = int(mlo[0]) + int(mhi[0])       # image layers to add on dim 0
    qz = 1
    if z_multiple > 1:
        if ncells[0] + e0 >= z_multiple:
            # shard-friendly z extent: round DOWN to a mesh multiple
            # (larger cells stay a superset of the kernel support);
            # image layers added below count toward the row total
            ncells[0] = max(((ncells[0] + e0) // z_multiple) * z_multiple
                            - e0, 1)
        elif e0:
            raise ValueError(
                "mirror walls on the slab axis need >= 1 interior row "
                "per shard (distribution too clustered)")
        else:
            # clustered distributions (large outer h) can demand z cells
            # WIDER than a slab: use z_multiple sub-support rows and widen
            # the shift stencil instead (qz rings cover the support)
            ncells[0] = z_multiple
            cell_z = (hi[0] - lo[0]) / z_multiple
            qz = max(int(np.ceil(support / cell_z)), 1)
    # mirror walls: one dedicated image-cell layer beyond each wall holds
    # the reflected ghost images (grid_mirror_extend); the stencil then
    # sees them as ordinary neighbour cells
    r_occ = [r]
    for k in range(ndim):
        if not (mlo[k] or mhi[k]):
            continue
        if k == 0 and qz > 1:
            raise ValueError("mirror walls on a sub-support slab axis "
                             "(qz > 1) are not supported")
        cell_k = (hi[k] - lo[k]) / ncells[k]
        for side, on in ((0, mlo[k]), (1, mhi[k])):
            if not on:
                continue
            bound = box.boxmin[k] if side == 0 else box.boxmax[k]
            sel = np.abs(r[:, k] - bound) < cell_k
            img = r[sel].copy()
            img[:, k] = 2.0 * bound - img[:, k]
            r_occ.append(img)
            ncells[k] += 1
            if side == 0:
                lo[k] -= cell_k
            else:
                hi[k] += cell_k
    r_occ = np.concatenate(r_occ, axis=0) if len(r_occ) > 1 else r
    ncells = tuple(ncells)
    extents = tuple(hi[k] - lo[k] for k in range(ndim))
    # occupancy (image particles included for mirror walls)
    cid = np.zeros(r_occ.shape[0], dtype=np.int64)
    for k in range(ndim):
        ck = np.clip(np.floor((r_occ[:, k] - lo[k]) / extents[k]
                              * ncells[k]).astype(np.int64),
                     0, ncells[k] - 1)
        cid = cid * ncells[k] + ck
    counts = np.bincount(cid, minlength=int(np.prod(ncells)))
    k_cell = int(np.ceil(counts.max() * k_slack)) + 1
    return Grid27Spec(ndim=ndim, ncells=ncells, lo=tuple(lo),
                      extents=tuple(extents), k_cell=k_cell,
                      periodic=tuple(periodic), qz=qz, mirror=tuple(walls))


class GridBinning(NamedTuple):
    cell_of: Array      # (N,) flat cell id per ORIGINAL particle
    slot_of: Array      # (N,) slot within the cell (may exceed K: overflow)
    overflow: Array     # () bool


def bin_particles(spec: Grid27Spec, r: Array,
                  discard: Array = None, zrow_max=None) -> GridBinning:
    """Assign (cell, slot) to each particle — no sort needed: slots come
    from a stable segment-cumsum over cell ids.

    `discard` (optional bool mask) routes particles to a virtual overflow
    cell so they consume no slots (the distributed mode's padding slots;
    they scatter/gather as drop/fill-zero).  `zrow_max` (optional traced
    scalar) clamps the dim-0 cell index below spec.ncells[0]-1 — the
    work-balanced distributed plan keeps its pad rows (the halo receive
    window) empty this way."""
    N = r.shape[0]
    cid = jnp.zeros((N,), dtype=jnp.int32)
    for k in range(spec.ndim):
        ck = jnp.floor((r[:, k] - spec.lo[k]) / spec.extents[k]
                       * spec.ncells[k]).astype(jnp.int32)
        hi = spec.ncells[k] - 1
        if k == 0 and zrow_max is not None:
            hi = jnp.minimum(jnp.asarray(zrow_max, jnp.int32), hi)
        ck = jnp.clip(ck, 0, hi)
        cid = cid * spec.ncells[k] + ck
    if discard is not None:
        cid = jnp.where(discard, spec.total_cells, cid)
    # slot = rank of the particle among same-cell particles (stable):
    # sort by cid, rank within runs, scatter back.
    order = jnp.argsort(cid, stable=True)
    cid_sorted = cid[order]
    idx = jnp.arange(N, dtype=jnp.int32)
    first_of_run = jnp.concatenate([
        jnp.zeros((1,), bool), cid_sorted[1:] != cid_sorted[:-1]])
    run_start = jnp.where(first_of_run, idx, 0)
    run_start = jax.lax.associative_scan(jnp.maximum, run_start)
    slot_sorted = idx - run_start
    slot = jnp.zeros((N,), dtype=jnp.int32).at[order].set(slot_sorted)
    valid = jnp.ones((N,), bool) if discard is None else ~discard
    overflow = jnp.any(valid & (slot >= spec.k_cell))
    return GridBinning(cell_of=cid, slot_of=jnp.minimum(slot,
                                                        spec.k_cell - 1),
                       overflow=overflow)


def grid_mirror_extend(box, spec: Grid27Spec, r: Array, v: Array,
                       alive: Array):
    """Reflected whole-set image copies for the grid path, one per mirror
    wall (reference reflect() ghosts, src/Headers/Particle.h:601-668 +
    GhostNeighbours.hpp): the image of a particle within one cell of the
    wall lands in that wall's dedicated image-cell layer (plan_grid27);
    images any deeper are beyond kernel reach of every interior particle
    and are discarded (routed to the virtual overflow cell).

    Returns (r_ext, v_ext, keep_ext) with leading axis (1+n_walls)*N; all
    other fields tile the parent (the caller uses jnp.tile)."""
    walls = box.mirror_walls()
    rs, vs, keeps = [r], [v], [alive]
    for (k, side) in walls:
        bound = box.boxmin[k] if side == 0 else box.boxmax[k]
        layers = spec.qz if k == 0 else 1
        cell_k = spec.extents[k] / spec.ncells[k]
        rad = layers * cell_k
        rs.append(r.at[:, k].set(2.0 * bound - r[:, k]))
        vs.append(v.at[:, k].set(-v[:, k]))
        keeps.append(alive & (jnp.abs(r[:, k] - bound) < rad))
    return (jnp.concatenate(rs, axis=0), jnp.concatenate(vs, axis=0),
            jnp.concatenate(keeps, axis=0))


def to_dense(spec: Grid27Spec, b: GridBinning, x: Array) -> Array:
    """(N, ...) -> (*ncells, K, ...) dense cell tensor."""
    K = spec.k_cell
    C = spec.total_cells
    out = jnp.zeros((C, K) + x.shape[1:], dtype=x.dtype)
    out = out.at[b.cell_of, b.slot_of].set(x)
    return out.reshape(spec.ncells + (K,) + x.shape[1:])


def dense_fill_mask(spec: Grid27Spec, b: GridBinning) -> Array:
    K = spec.k_cell
    C = spec.total_cells
    fill = jnp.zeros((C, K), dtype=bool)
    fill = fill.at[b.cell_of, b.slot_of].set(True)
    return fill.reshape(spec.ncells + (K,))


def from_dense(spec: Grid27Spec, b: GridBinning, x_d: Array) -> Array:
    """(*ncells, K, ...) -> (N, ...)."""
    K = spec.k_cell
    C = spec.total_cells
    flat = x_d.reshape((C, K) + x_d.shape[spec.ndim + 1:])
    return flat[b.cell_of, b.slot_of]


def add_ghost_layers(spec: Grid27Spec, x_d: Array, shift_vec=None,
                     dims=None) -> Array:
    """Pad the grid with ghost layers per face (qz layers on dim 0, one on
    the others).

    Periodic dims wrap-copy (with optional coordinate shift ±L applied via
    shift_vec for position tensors); open dims pad with zeros (masked by the
    fill tensor which pads to False).  `dims` restricts which grid axes get
    ghosted (the sharded path supplies dim 0 via ppermute halos).
    """
    nd = spec.ndim
    out = x_d
    for k in (range(nd) if dims is None else dims):
        n = spec.ncells[k]
        q = spec.qz if k == 0 else 1
        if spec.periodic[k]:
            lo_slice = jax.lax.slice_in_dim(out, n - q, n, axis=k)
            hi_slice = jax.lax.slice_in_dim(out, 0, q, axis=k)
            if shift_vec is not None:
                L = spec.extents[k]
                lo_slice = lo_slice.at[..., k].add(-L)
                hi_slice = hi_slice.at[..., k].add(L)
            out = jnp.concatenate([lo_slice, out, hi_slice], axis=k)
        else:
            pad = [(0, 0)] * out.ndim
            pad[k] = (q, q)
            out = jnp.pad(out, pad)
    return out


def _shifts(ndim: int, qz: int = 1):
    z_range = tuple(range(2 * qz + 1))
    return list(itertools.product(z_range,
                                  *([(0, 1, 2)] * (ndim - 1))))


def _shift_view(spec: Grid27Spec, padded: Array, sh) -> Array:
    """Static slice selecting the (dz, dy, dx)-shifted neighbour block."""
    out = padded
    for k in range(spec.ndim):
        out = jax.lax.slice_in_dim(out, sh[k], sh[k] + spec.ncells[k],
                                   axis=k)
    return out


def _concat_shift_table(spec: Grid27Spec, padded: Array,
                        k_axis_from_end: int) -> Array:
    """All shift views concatenated along the slot axis: (*nc, K, ...) ->
    (*nc, S*K, ...) where S = stencil size.

    One (cells, K, S*K) pair block per slab instead of S (cells, K, K)
    blocks: every neighbour sum becomes a single reduction over the last
    axis.  The table is a real copy (S slices), but it is linear in
    pairs/K — negligible next to the quadratic pair work it feeds."""
    axis = padded.ndim - 1 - k_axis_from_end
    views = [_shift_view(spec, padded, sh)
             for sh in _shifts(spec.ndim, spec.qz)]
    return jnp.concatenate(views, axis=axis)


class Grid27Density(NamedTuple):
    h: Array
    rho: Array
    invomega: Array
    zeta: Array
    hfactor: Array
    overflow: Array


ITER_FP = 30
ITER_MAX = 150


def density_grid27(kern: SmoothingKernel, spec: Grid27Spec,
                   h_fac: float, h_converge: float,
                   r_d: Array, m_d: Array, h_d: Array, fill: Array,
                   hmax: float, slab_chunk: int = None,
                   ghost_fn=None, count_fill: Array = None) -> Grid27Density:
    """Grad-h h-rho iteration over the structured grid (27 static shifts).

    All tensors are dense (*ncells, K, ...); returns dense results.
    Mirrors GradhSph::ComputeH (GradhSph.cpp:142-326) exactly.  The grid is
    processed in slabs along the first dimension (lax.map) so that (a) each
    slab's while_loop converges independently — stragglers don't force
    extra sweeps over the whole grid — and (b) the (cells, K, K) pair
    temporaries stay small.

    `count_fill` (optional, defaults to `fill`) restricts the OVERFLOW
    check to a subset of filled slots: the mirror path's image copies near
    the outer edge of the image layer legitimately miss their own
    second-layer neighbours so their h runs past hmax, but their h result
    is discarded (parents re-scatter onto images before the force pass) —
    only PARENT slots decide whether the grid must be replanned.
    """
    nd = spec.ndim
    invndim = 1.0 / nd
    ghost = ghost_fn or add_ghost_layers
    rp_full = ghost(spec, r_d, shift_vec=True)
    mp_full = ghost(spec, m_d)
    fp_full = ghost(spec, fill)
    mp_full = jnp.where(fp_full, mp_full, 0.0)

    n0 = spec.ncells[0]
    if slab_chunk is None:
        slab_chunk = _auto_slab(spec, concat=True,
                                itemsize=r_d.dtype.itemsize)
    slab_chunk = min(slab_chunk, n0)
    n_slabs = -(-n0 // slab_chunk)
    pad0_amount = n_slabs * slab_chunk - n0

    def pad_first(x, fill_val=0):
        widths = [(0, pad0_amount)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill_val)

    # pad the GHOSTED tensors too so the last slab's view stays aligned
    rp_full = pad_first(rp_full)
    mp_full = pad_first(mp_full)

    # overlapping ghosted slabs: slab s covers rows [s*c, s*c + c + 2*qz)
    # of the ghosted tensors
    qz = spec.qz

    def slab_view(x_p, s, c):
        return jax.lax.dynamic_slice_in_dim(x_p, s * c, c + 2 * qz, axis=0)

    def slab_fn(s):
        """Converge one slab of slab_chunk rows along dim 0."""
        c = slab_chunk
        # slab-local ghosted inputs (c+2 rows; inner shifts stay static)
        rp = slab_view(rp_full, s, c)
        mp = slab_view(mp_full, s, c)
        r_dc = jax.lax.dynamic_slice_in_dim(pad_first(r_d), s * c, c, axis=0)
        m_dc = jax.lax.dynamic_slice_in_dim(pad_first(m_d), s * c, c, axis=0)
        h_dc = jax.lax.dynamic_slice_in_dim(pad_first(h_d, 1), s * c, c,
                                            axis=0)
        fill_c = jax.lax.dynamic_slice_in_dim(pad_first(fill), s * c, c,
                                              axis=0)
        sub = dataclasses.replace(spec, ncells=(c,) + spec.ncells[1:])
        # concatenated neighbour tables, built ONCE per slab (reused by
        # every h iteration): one (c, K, S*K) pair block per sweep instead
        # of S separate (c, K, K) blocks — see _concat_shift_table
        r_tab = _concat_shift_table(sub, rp, 1)
        m_tab = _concat_shift_table(sub, mp, 0)
        # pair separations are h-independent: materialise drsqd ONCE per
        # slab (a loop constant) instead of re-deriving the (c, K, S*K, nd)
        # dr tensor inside every h-iteration sweep
        dr = r_tab[..., None, :, :] - r_dc[..., :, None, :]
        drsqd = jnp.sum(dr * dr, axis=-1)

        def sums_at(h):
            invh = 1.0 / h
            invhsqd = invh * invh
            ssqd = drsqd * invhsqd[..., None]
            m_b = m_tab[..., None, :]
            rho = jnp.sum(m_b * kern.w0_s2(ssqd), -1)
            invom = jnp.sum(m_b * kern.womega_s2(ssqd), -1)
            zeta = jnp.sum(m_b * kern.wzeta_s2(ssqd), -1)
            hfac = invh ** nd
            return rho * hfac, invom * hfac * invh, zeta * invhsqd

        m_t = jnp.maximum(m_dc, 1e-30)

        def h_rho(rho):
            return h_fac * (m_t / jnp.maximum(rho, 1e-300)) ** invndim

        def body(carry):
            h, _, _, _, lo, hi, it, done = carry
            rho, invom, zeta = sums_at(h)
            h_target = h_rho(rho)
            conv = (rho > 0.0) & (jnp.abs(h - h_target) / h < h_converge)
            too_big = (rho < 1e-30) | (h > h_target)
            start_bis = it >= ITER_FP
            hi_n = jnp.where(start_bis & too_big & ~conv, h, hi)
            lo_n = jnp.where(start_bis & ~too_big & ~conv, h, lo)
            h_new = jnp.where(it < ITER_FP, h_target, 0.5 * (lo_n + hi_n))
            h_out = jnp.where(conv | done, h,
                              jnp.clip(h_new, 1e-6 * hmax, hmax))
            return (h_out, rho, invom, zeta, lo_n, hi_n, it + 1,
                    done | conv)

        def cond(carry):
            *_, it, done = carry
            return (it < ITER_MAX) & ~jnp.all(done)

        h0 = jnp.clip(jnp.where(fill_c, h_dc, 0.5 * hmax),
                      1e-6 * hmax, hmax)
        z = jnp.zeros_like(h0)
        carry0 = (h0, z, z, z, jnp.zeros_like(h0),
                  jnp.full_like(h0, hmax), jnp.asarray(0), ~fill_c)
        h, rho, invom, zeta, lo, hi, it, done = jax.lax.while_loop(
            cond, body, carry0)
        return h, rho, invom, zeta, done

    h, rho, invom, zeta, done = jax.lax.map(
        slab_fn, jnp.arange(n_slabs, dtype=jnp.int32))
    unpad = lambda x: x.reshape((n_slabs * slab_chunk,) + x.shape[2:])[:n0]
    h, rho, invom, zeta, done = map(unpad, (h, rho, invom, zeta, done))

    m_t = jnp.maximum(m_d, 1e-30)

    def h_rho(rho):
        return h_fac * (m_t / jnp.maximum(rho, 1e-300)) ** invndim

    h_final = h_rho(rho)
    invh = 1.0 / h_final
    hfactor = invh ** (nd + 1)
    dh_drho = -invndim * h_final / jnp.maximum(rho, 1e-300)
    invomega = 1.0 / (1.0 - dh_drho * invom)
    zeta_final = dh_drho * zeta * invomega
    cfill = fill if count_fill is None else count_fill
    overflow = jnp.any(jnp.where(cfill, ~done, False)) | \
        jnp.any(jnp.where(cfill, h_final, 0.0) > 0.99 * hmax)
    # Sanitise EMPTY slots to benign values: they participate as (masked)
    # neighbours in the force pass, and NaN/inf there would poison valid
    # pairs through 0*NaN.
    sane = lambda x, v: jnp.where(fill, x, v)
    return Grid27Density(h=sane(h_final, 1.0), rho=sane(rho, 1.0),
                         invomega=sane(invomega, 1.0),
                         zeta=sane(zeta_final, 0.0),
                         hfactor=sane(hfactor, 0.0),
                         overflow=overflow)


# dissipation codes shared with ops.forces
from .forces import ACOND_NONE, ACOND_PRICE2008, ACOND_WADSLEY2008  # noqa: E402
from .forces import AVISC_MON97, AVISC_MON97MM97, AVISC_NONE  # noqa: E402


# Pair temporaries of one slab that can be live at once (the density
# pass keeps drsqd plus the kernel sums of each h iteration; the force
# pass its kernel, viscosity and geometry terms), and the share of the
# device's memory the slab may take.
SLAB_PAIR_TEMPS = 8
SLAB_MEMORY_FRACTION = 1.0 / 32


def device_bytes_limit(device=None) -> int:
    """Bytes the device can allocate, as the runtime reports them.  The
    CPU backend reports none; its memory is the host's RAM, shared by
    every (virtual) CPU device of the process.  Any other device that
    reports no limit is an error, not a default."""
    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    if device.platform == "cpu":
        ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return ram // len(jax.devices("cpu"))
    raise RuntimeError(f"device {device.device_kind!r} reports no "
                       "bytes_limit; cannot size the pair slabs")


def _auto_slab(spec: Grid27Spec, concat: bool = False, itemsize: int = 4,
               bytes_limit: int = None) -> int:
    """Largest dim-0 slab whose pair temporaries fit the budget:
    SLAB_PAIR_TEMPS live (cells, K, cols) arrays of `itemsize` bytes
    within SLAB_MEMORY_FRACTION of the device memory.  concat=True sizes
    for the (cells, K, S*K) concatenated-table block instead of
    (cells, K, K)."""
    k = spec.k_cell
    cols = k * len(_shifts(spec.ndim, spec.qz)) if concat else k
    row_bytes = (int(np.prod(spec.ncells[1:])) * k * cols * itemsize
                 * SLAB_PAIR_TEMPS)
    if bytes_limit is None:
        bytes_limit = device_bytes_limit()
    return max(1, int(SLAB_MEMORY_FRACTION * bytes_limit) // row_bytes)


def forces_grid27(kern: SmoothingKernel, visc: ArtificialViscosity,
                  spec: Grid27Spec, dense: Dict[str, Array], fill: Array,
                  slab_chunk: int = None, ghost_fn=None):
    """Hydro forces over the structured grid (27 static shifts), processed
    in dim-0 slabs (lax.map) to bound the (cells, K, K) pair temporaries.

    dense: (*ncells, K[, ndim]) tensors for r, v, m, h, rho, u, pressure,
    sound, invomega, hfactor, alpha.  Returns dense (a, dudt, div_v,
    dalphadt).  Physics identical to GradhSph::ComputeSphHydroForces
    (GradhSph.cpp:361-460).
    """
    nd = spec.ndim
    r_d_full = dense["r"]
    scalar_keys = ("m", "h", "rho", "u", "pressure", "sound", "invomega",
                   "hfactor", "alpha")
    packed_full = jnp.stack([dense[k] for k in scalar_keys], axis=-1)
    i_of = {k: i for i, k in enumerate(scalar_keys)}

    n0 = spec.ncells[0]
    if slab_chunk is None:
        slab_chunk = _auto_slab(spec, concat=True,
                                itemsize=r_d_full.dtype.itemsize)
    slab_chunk = min(slab_chunk, n0)
    n_slabs = -(-n0 // slab_chunk)
    pad0_amount = n_slabs * slab_chunk - n0

    def pad_first(x, fill_val=0):
        widths = [(0, pad0_amount)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill_val)

    ghost = ghost_fn or add_ghost_layers
    rp_full = pad_first(ghost(spec, r_d_full, shift_vec=True))
    vp_full = pad_first(ghost(spec, dense["v"]))
    pkp_full = pad_first(ghost(spec, packed_full))
    fp_full = pad_first(ghost(spec, fill))

    def slab_fn(s):
        c = slab_chunk
        sl = lambda x_p: jax.lax.dynamic_slice_in_dim(
            x_p, s * c, c + 2 * spec.qz, axis=0)
        ce = lambda x: jax.lax.dynamic_slice_in_dim(pad_first(x), s * c, c,
                                                    axis=0)
        rp, vp, pkp, fp_ = sl(rp_full), sl(vp_full), sl(pkp_full), \
            sl(fp_full)
        sub = dataclasses.replace(spec, ncells=(c,) + spec.ncells[1:])
        r_d = ce(r_d_full)
        v_i = ce(dense["v"])
        h_i = jnp.maximum(ce(dense["h"]), 1e-30)
        rho_i = ce(dense["rho"])
        invh_i = 1.0 / h_i
        invrho_i = 1.0 / jnp.maximum(rho_i, 1e-300)
        press_i = ce(dense["pressure"])
        sound_i = ce(dense["sound"])
        invom_i = ce(dense["invomega"])
        hfac_i = ce(dense["hfactor"])
        alpha_i = ce(dense["alpha"])
        u_i = ce(dense["u"])

        a = jnp.zeros_like(r_d)
        dudt = jnp.zeros_like(h_i)
        div_v = jnp.zeros_like(h_i)

        return _force_shifts(kern, visc, sub, nd, i_of,
                             rp, vp, pkp, fp_, r_d, v_i, h_i, invh_i,
                             invrho_i, press_i, sound_i, invom_i, hfac_i,
                             alpha_i, u_i, a, dudt, div_v)

    a, dudt, div_v = jax.lax.map(slab_fn,
                                 jnp.arange(n_slabs, dtype=jnp.int32))
    unpad = lambda x: x.reshape((n_slabs * slab_chunk,) + x.shape[2:])[:n0]
    a, dudt, div_v = map(unpad, (a, dudt, div_v))

    h_i = jnp.maximum(dense["h"], 1e-30)
    invh_i = 1.0 / h_i
    rho_i = dense["rho"]
    invrho_i = 1.0 / jnp.maximum(rho_i, 1e-300)
    press_i = dense["pressure"]
    sound_i = dense["sound"]
    invom_i = dense["invomega"]
    alpha_i = dense["alpha"]

    div_v = div_v * invrho_i
    dudt = dudt - press_i * div_v * invrho_i * invom_i
    dalphadt = jnp.zeros_like(h_i)
    if visc.avisc == AVISC_MON97MM97:
        dalphadt = (0.1 * sound_i * (visc.alpha_visc_min - alpha_i) * invh_i
                    + jnp.maximum(-div_v, 0.0) * (visc.alpha_visc - alpha_i))
    return a, dudt, div_v, dalphadt


def _force_shifts(kern, visc, spec, nd, i_of, rp, vp, pkp, fp_, r_d, v_i,
                  h_i, invh_i, invrho_i, press_i, sound_i, invom_i, hfac_i,
                  alpha_i, u_i, a, dudt, div_v):
    """Accumulate pair forces over the shift stencil for one slab — ONE
    (cells, K, S*K) pair block over the concatenated neighbour tables
    (see _concat_shift_table)."""
    r_nb = _concat_shift_table(spec, rp, 1)
    v_nb = _concat_shift_table(spec, vp, 1)
    pk_nb = _concat_shift_table(spec, pkp, 1)
    f_nb = _concat_shift_table(spec, fp_, 0)

    g = lambda k: pk_nb[..., None, :, i_of[k]]     # (*nc, 1, S*K)

    # plain pair differences: the self pair (central-shift slot k, row k)
    # and coincident particles come out exactly 0 and are masked by it
    dr = r_nb[..., None, :, :] - r_d[..., :, None, :]   # (*nc, K, S*K, nd)
    drsqd = jnp.sum(dr * dr, axis=-1)
    valid = f_nb[..., None, :] & (drsqd > 0.0)
    drmag = jnp.sqrt(drsqd)
    inv_drmag = jnp.where(valid,
                          jax.lax.rsqrt(jnp.where(valid, drsqd, 1.0)), 0.0)

    m_j = g("m")
    h_j = jnp.where(valid, g("h"), 1.0)
    rho_j = jnp.where(valid, g("rho"), 1.0)
    invrho_j = 1.0 / rho_j
    wkerni = hfac_i[..., None] * kern.w1(drmag * invh_i[..., None])
    wkernj = g("hfactor") * kern.w1(drmag / h_j)
    wkerni = jnp.where(valid, wkerni, 0.0)
    wkernj = jnp.where(valid, wkernj, 0.0)

    dvdr = jnp.sum((v_nb[..., None, :, :] - v_i[..., :, None, :]) * dr,
                   axis=-1) * inv_drmag
    div_v = div_v - jnp.sum(m_j * dvdr * wkerni, axis=-1)

    paux = ((press_i * invom_i * invrho_i * invrho_i)[..., None] * wkerni
            + g("pressure") * g("invomega") * invrho_j * invrho_j
            * wkernj)

    approach = valid & (dvdr < 0.0)
    if visc.avisc != AVISC_NONE:
        winvrho = 0.25 * (wkerni + wkernj) * (invrho_i[..., None]
                                              + invrho_j)
        if visc.avisc == AVISC_MON97:
            alpha_eff = visc.alpha_visc
        else:
            alpha_eff = 0.5 * (alpha_i[..., None] + g("alpha"))
        vsignal = (sound_i[..., None] + g("sound")
                   - visc.beta_visc * alpha_eff * dvdr)
        paux = paux - jnp.where(approach,
                                alpha_eff * vsignal * dvdr * winvrho, 0.0)
        dudt = dudt - jnp.sum(
            jnp.where(approach,
                      0.5 * m_j * alpha_eff * vsignal * dvdr * dvdr
                      * winvrho, 0.0), axis=-1)
        if visc.acond == ACOND_WADSLEY2008:
            cond_t = m_j * dvdr * (g("u") - u_i[..., None]) * (
                invrho_i[..., None] * wkerni + invrho_j * wkernj)
            dudt = dudt + jnp.sum(jnp.where(approach, cond_t, 0.0), -1)
        elif visc.acond == ACOND_PRICE2008:
            cond_t = (0.5 * m_j * (u_i[..., None] - g("u")) * winvrho
                      * (invrho_i[..., None] + invrho_j)
                      * jnp.sqrt(jnp.abs(press_i[..., None]
                                         - g("pressure"))))
            dudt = dudt + jnp.sum(jnp.where(approach, cond_t, 0.0), -1)

    w_pair = m_j * paux * inv_drmag                   # (*nc, K, S*K)
    a = a + jnp.sum(w_pair[..., None] * dr, axis=-2)

    # div_v normalisation and dalphadt happen in the caller (whole grid)
    return a, dudt, div_v


def _hydro_pass_grid27_mirror(kern, visc, box: DomainBox, spec: Grid27Spec,
                              eos, h_fac, h_converge, hydro_forces: bool,
                              s: SphState, alive: Array) -> SphState:
    """Mirror-wall variant of hydro_pass_grid27: the particle set is
    extended with reflected image copies (grid_mirror_extend) binned into
    the wall's image-cell layer, so the unmodified 27-shift kernels see
    mirror ghosts as ordinary neighbours (the reference's mirror ghost
    particles, src/Hydrodynamics/Ghosts.cpp + GhostNeighbours.hpp).

    Images do not iterate their own h; after the density pass every image
    slot is re-scattered with its PARENT's updated fields (the reference
    copies ghost data from parents each step, CopyHydroDataToGhosts,
    src/Hydrodynamics/Ghosts.cpp:47)."""
    N = s.N
    live = alive if alive is not None else jnp.ones((N,), bool)
    r_ext, v_ext, keep = grid_mirror_extend(box, spec, s.r, s.v, live)
    n_img = r_ext.shape[0] // N
    tile = lambda x: jnp.tile(x, (n_img,) + (1,) * (x.ndim - 1))
    b = bin_particles(spec, r_ext, discard=~keep)
    hmax = hmax_of(spec, kern.kernrange)
    d = lambda x: to_dense(spec, b, x)
    fill = dense_fill_mask(spec, b)
    r_d = d(r_ext)

    # only PARENT slots decide overflow: edge-of-band images miss their
    # own second-layer neighbours and legitimately run past hmax
    is_parent = jnp.arange(r_ext.shape[0]) < N
    dens = density_grid27(kern, spec, h_fac, h_converge,
                          r_d, d(tile(s.m)), d(tile(s.h)), fill, hmax,
                          count_fill=d(keep & is_parent))
    back = lambda x_d: from_dense(spec, b, x_d)[:N]
    sane = lambda x_d, v0: jnp.where(live, back(x_d), v0)
    h_new = sane(dens.h, 1.0)
    rho_new = sane(dens.rho, 1.0)
    invom_new = sane(dens.invomega, 1.0)
    zeta_new = sane(dens.zeta, 0.0)
    hfac_new = sane(dens.hfactor, 0.0)
    eos_kw = {}
    if getattr(eos, "needs_ionfrac", False):
        eos_kw["ionfrac"] = s.ionfrac
    u_new, press_new, sound_new = eos.thermal_update(
        jnp.maximum(rho_new, 1e-30), s.u, **eos_kw)
    u_new = jnp.where(live, u_new, 1e-30)
    press_new = jnp.where(live, press_new, 0.0)
    sound_new = jnp.where(live, sound_new, 0.0)

    if hydro_forces:
        dense_fields = {
            "r": r_d, "v": d(v_ext), "m": d(tile(s.m)),
            "h": d(tile(h_new)), "rho": d(tile(rho_new)),
            "u": d(tile(u_new)), "pressure": d(tile(press_new)),
            "sound": d(tile(sound_new)), "invomega": d(tile(invom_new)),
            "hfactor": d(tile(hfac_new)), "alpha": d(tile(s.alpha)),
        }
        a_d, dudt_d, div_v_d, _ = forces_grid27(kern, visc, spec,
                                                dense_fields, fill)
        a_new = jnp.where(live[:, None], back(a_d), 0.0)
        dudt_new = sane(dudt_d, 0.0)
        div_v_new = sane(div_v_d, 0.0)
    else:
        a_new = jnp.zeros_like(s.r)
        dudt_new = jnp.zeros_like(s.m)
        div_v_new = jnp.zeros_like(s.m)
    return s.replace(
        h=h_new, rho=rho_new, invomega=invom_new, zeta=zeta_new,
        hfactor=hfac_new, u=u_new, pressure=press_new, sound=sound_new,
        a=a_new, dudt=dudt_new, div_v=div_v_new,
        neib_overflow=s.neib_overflow | dens.overflow | b.overflow)


def hydro_pass_grid27(kern, visc, box: DomainBox, spec: Grid27Spec, eos,
                      h_fac, h_converge, hydro_forces: bool,
                      s: SphState, alive: Array = None) -> SphState:
    """Full structured-grid hydro pass: bin -> dense -> density -> EOS ->
    forces -> back to particle order.

    `alive` (optional) masks dead particles (accreted corpses, unfired SN
    spares) out of the dense fill mask: they contribute to no sums, and
    their own fields come back as benign constants (matching the brute
    path's dead-slot sanitisation)."""
    if spec.mirror:
        return _hydro_pass_grid27_mirror(kern, visc, box, spec, eos,
                                         h_fac, h_converge, hydro_forces,
                                         s, alive)
    nd = s.ndim
    b = bin_particles(spec, s.r)
    hmax = hmax_of(spec, kern.kernrange)

    d = lambda x: to_dense(spec, b, x)
    fill = dense_fill_mask(spec, b)
    if alive is not None:
        fill = fill & d(alive)
    r_d, v_d, m_d, h_d = d(s.r), d(s.v), d(s.m), d(s.h)

    dens = density_grid27(kern, spec, h_fac, h_converge,
                          r_d, m_d, h_d, fill, hmax)
    eos_kw = {}
    if getattr(eos, "needs_ionfrac", False):
        eos_kw["ionfrac"] = d(s.ionfrac)
    u_d, pressure_d, sound_d = eos.thermal_update(
        jnp.maximum(dens.rho, 1e-30), d(s.u), **eos_kw)

    if hydro_forces:
        dense_fields = {
            "r": r_d, "v": v_d, "m": m_d, "h": dens.h, "rho": dens.rho,
            "u": u_d, "pressure": pressure_d, "sound": sound_d,
            "invomega": dens.invomega, "hfactor": dens.hfactor,
            "alpha": d(s.alpha),
        }
        a_d, dudt_d, div_v_d, _ = forces_grid27(kern, visc, spec,
                                                dense_fields, fill)
    else:
        a_d = jnp.zeros_like(r_d)
        dudt_d = jnp.zeros_like(m_d)
        div_v_d = jnp.zeros_like(m_d)

    back = lambda x_d: from_dense(spec, b, x_d)
    live = alive if alive is not None else jnp.ones((s.N,), bool)
    sane = lambda x_d, v: jnp.where(live, back(x_d), v)
    return s.replace(
        h=sane(dens.h, 1.0), rho=sane(dens.rho, 1.0),
        invomega=sane(dens.invomega, 1.0), zeta=sane(dens.zeta, 0.0),
        hfactor=sane(dens.hfactor, 0.0),
        u=sane(u_d, 1e-30), pressure=sane(pressure_d, 0.0),
        sound=sane(sound_d, 0.0),
        a=jnp.where(live[:, None], back(a_d), 0.0),
        dudt=sane(dudt_d, 0.0), div_v=sane(div_v_d, 0.0),
        neib_overflow=dens.overflow | b.overflow)
