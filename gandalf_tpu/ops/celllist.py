"""Cell-list neighbour search (gathered neighbour views).

Replaces the reference's per-step KD-tree walks (src/Tree/KDTree.cpp,
src/Tree/Tree.cpp:208-291) with a dense formulation:

1. bin particles into a uniform grid with cell edge >= kernrange * h_max,
2. sort particles by cell id (one `argsort` per rebuild — the analogue of
   the reference's tree (re)build cadence, ntreebuildstep),
3. every particle's neighbour candidates are the particles of its 3^ndim
   adjacent cells, materialised as a statically-shaped (N, 3^ndim * K_cell)
   gather with a validity mask.  Compact-kernel weights zero out the
   out-of-range candidates, so correctness never depends on the pruning.

Static capacities (K_cell) follow the reference's Nneibmax pattern
(GradhSphTree.cpp:172-185): chosen from the particle distribution at build
time on the host, with overflow detection for the driver to rebuild bigger.

Periodic boundaries: cells wrap (neighbour cell ids computed modulo the
grid), displacements use min-image.  Mirror walls: reflected image copies
are appended before binning (ops.neighbors.extend_with_mirror_images).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..state import DomainBox

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (compile-time constants)."""

    ndim: int
    ncells: Tuple[int, ...]       # cells per dimension
    lo: Tuple[float, ...]
    extents: Tuple[float, ...]    # grid extent per dimension
    cell_size: float
    k_cell: int                   # max particles per cell (static capacity)
    periodic: Tuple[bool, ...]    # wrap per dimension

    @property
    def total_cells(self) -> int:
        return int(np.prod(self.ncells))

    @property
    def n_adjacent(self) -> int:
        return 3 ** self.ndim


def plan_grid(box: DomainBox, r: np.ndarray, h_max: float, kernrange: float,
              k_cell_slack: float = 1.6) -> GridSpec:
    """Host-side grid planning (once per rebuild cadence).

    Cell edge >= kernrange*h_max so 3^ndim adjacent cells cover every
    interaction sphere; K_cell from the observed max occupancy + slack.
    """
    r = np.asarray(r)
    ndim = r.shape[1]
    support = float(kernrange * h_max)
    pdims = box.periodic_dims()
    lo, hi, periodic = [], [], []
    for k in range(ndim):
        if k in pdims:
            lo_k, hi_k = box.boxmin[k], box.boxmax[k]
            periodic.append(True)
        else:
            lo_k = float(r[:, k].min()) - 1e-6
            hi_k = float(r[:, k].max()) + 1e-6
            periodic.append(False)
        lo.append(lo_k)
        hi.append(hi_k)
    extents = [hi[k] - lo[k] for k in range(ndim)]
    # at least one cell; for periodic dims the count must tile the box exactly
    ncells = []
    cell_size = support
    for k in range(ndim):
        n = max(int(np.floor(extents[k] / support)), 1)
        ncells.append(n)
    # effective cell size per dim >= support guaranteed by floor division;
    # use per-dim sizes implicitly via ncells; store the nominal size.
    spec_ncells = tuple(ncells)

    # occupancy for K_cell
    cid = _cell_ids_np(r, spec_ncells, lo, extents)
    counts = np.bincount(cid, minlength=int(np.prod(spec_ncells)))
    k_cell = int(np.ceil(counts.max() * k_cell_slack)) + 1
    return GridSpec(ndim=ndim, ncells=spec_ncells, lo=tuple(lo),
                    extents=tuple(extents), cell_size=cell_size,
                    k_cell=k_cell, periodic=tuple(periodic))


def _cell_ids_np(r, ncells, lo, extents):
    ndim = r.shape[1]
    cid = np.zeros(r.shape[0], dtype=np.int64)
    for k in range(ndim):
        ck = np.floor((r[:, k] - lo[k]) / extents[k] * ncells[k]).astype(
            np.int64)
        ck = np.clip(ck, 0, ncells[k] - 1)
        cid = cid * ncells[k] + ck
    return cid


class CellList(NamedTuple):
    """Device-side sorted cell-list structure."""

    order: Array          # (N,) permutation: sorted position -> original idx
    cell_of: Array        # (N,) cell id per SORTED particle
    cell_start: Array     # (C,) first sorted index of each cell
    cell_count: Array     # (C,) particles in each cell
    overflow: Array       # () bool: any cell exceeded k_cell


def build_cell_list(spec: GridSpec, r: Array) -> CellList:
    """Bin + sort particles by cell (device-side, jittable)."""
    N = r.shape[0]
    cid = jnp.zeros((N,), dtype=jnp.int32)
    for k in range(spec.ndim):
        ck = jnp.floor((r[:, k] - spec.lo[k]) / spec.extents[k]
                       * spec.ncells[k]).astype(jnp.int32)
        ck = jnp.clip(ck, 0, spec.ncells[k] - 1)
        cid = cid * spec.ncells[k] + ck
    order = jnp.argsort(cid)
    cid_sorted = cid[order]
    C = spec.total_cells
    cell_start = jnp.searchsorted(cid_sorted, jnp.arange(C, dtype=jnp.int32),
                                  side="left").astype(jnp.int32)
    cell_end = jnp.searchsorted(cid_sorted, jnp.arange(C, dtype=jnp.int32),
                                side="right").astype(jnp.int32)
    cell_count = cell_end - cell_start
    overflow = jnp.any(cell_count > spec.k_cell)
    return CellList(order=order, cell_of=cid_sorted, cell_start=cell_start,
                    cell_count=cell_count, overflow=overflow)


def _adjacent_cell_ids(spec: GridSpec, cell_of: Array) -> Tuple[Array, Array]:
    """For each sorted particle, the 3^ndim adjacent (wrapped/clipped) cell
    ids: (N, A) plus validity (False where a non-periodic edge clips)."""
    # unflatten cell id -> per-dim coords
    coords = []
    cid = cell_of
    for k in reversed(range(spec.ndim)):
        n = spec.ncells[k]
        coords.append(cid % n)
        cid = cid // n
    coords = coords[::-1]                      # per-dim arrays, (N,)

    offsets = np.stack(np.meshgrid(*([[-1, 0, 1]] * spec.ndim),
                                   indexing="ij"), axis=-1).reshape(-1,
                                                                    spec.ndim)
    A = offsets.shape[0]
    nbr_id = jnp.zeros((cell_of.shape[0], A), dtype=jnp.int32)
    valid = jnp.ones((cell_of.shape[0], A), dtype=bool)
    for k in range(spec.ndim):
        n = spec.ncells[k]
        ck = coords[k][:, None] + jnp.asarray(offsets[:, k], dtype=jnp.int32)
        if spec.periodic[k]:
            ck = jnp.mod(ck, n)
        else:
            inside = (ck >= 0) & (ck < n)
            valid = valid & inside
            ck = jnp.clip(ck, 0, n - 1)
        nbr_id = nbr_id * n + ck
    return nbr_id, valid


class NeighborCandidates(NamedTuple):
    """Statically-shaped candidate neighbour indices for sorted particles."""

    idx: Array    # (N, A*K) indices into SORTED arrays
    mask: Array   # (N, A*K) validity


def gather_candidates(spec: GridSpec, cl: CellList,
                      cell_of_slice: Optional[Array] = None
                      ) -> NeighborCandidates:
    """Candidate indices from the 3^ndim adjacent cells.

    With `cell_of_slice` (a chunk of cl.cell_of), candidates are produced
    only for that chunk — the chunked pipelines call this inside `lax.map`
    so the (chunk, A*K) intermediates never materialise at full N.
    """
    cell_of = cl.cell_of if cell_of_slice is None else cell_of_slice
    nbr_id, cell_valid = _adjacent_cell_ids(spec, cell_of)
    K = spec.k_cell
    starts = cl.cell_start[nbr_id]                    # (n, A)
    counts = cl.cell_count[nbr_id]                    # (n, A)
    slot = jnp.arange(K, dtype=jnp.int32)             # (K,)
    idx = starts[:, :, None] + slot[None, None, :]    # (n, A, K)
    mask = (slot[None, None, :] < counts[:, :, None]) & cell_valid[:, :, None]
    Ntot = cl.order.shape[0]
    idx = jnp.clip(idx, 0, Ntot - 1)
    n, A = nbr_id.shape
    return NeighborCandidates(idx=idx.reshape(n, A * K),
                              mask=mask.reshape(n, A * K))
