"""Barnes-Hut gravity tree: implicit balanced tree over Morton buckets.

Re-design of the reference KD-tree gravity walk (src/Tree/KDTree.cpp,
Tree::ComputeGravityInteractionAndGhostList src/Tree/Tree.cpp:628-735,
multipole kernels src/Headers/NeighbourSearch.h:350-520) for XLA:

- particles are sorted by Morton code once per rebuild (the analogue of
  KDTree::BuildTree's recursive median splits — Morton order gives the same
  spatial locality with a single `argsort`),
- the tree is IMPLICIT: leaf g covers sorted particles [g*L, (g+1)*L); level
  ell cell c covers 2^(D-ell) leaves.  Cell properties (mass, COM, bounding
  centre/half-extent, quadrupole moments) are computed bottom-up with
  reshape-reductions — no pointers, no copen/cnext indices
  (KDTree::StockCellProperties :808-1090 equivalent),
- the walk is per leaf GROUP (all L particles share one interaction list,
  like the reference's per-cell OpenMP walk): a compacted frontier of cell
  ids per level.  Cells passing the geometric MAC contribute multipole
  forces; failing cells expand their two children into the next frontier
  (compaction is a cumsum+scatter, no sort).  Cells still open at the leaf
  level become the direct particle-particle near-field list, gathered and
  evaluated ONCE as a single dense (L x Wn*L) pair block,
- `fast` mode evaluates the far field at the group centre with a first-order
  Taylor expansion (acceleration Jacobian), the reference's cell-centred
  fast-multipole variant (ComputeFastMonopoleForces,
  src/Headers/NeighbourSearch.h:769); exact mode evaluates multipoles at
  every particle (reference ComputeCellMonopole/QuadrupoleForces).

Monopole + quadrupole supported (multipole = "monopole" | "quadrupole" |
"fast_monopole" | "fast_quadrupole").
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

# float32 contractions must not fall to TF32 on GPUs that have it: the
# quadrupole moments and the Taylor far field are sums of products that
# TF32's 10-bit mantissa would truncate.
_HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Static tree geometry."""

    n_pad: int          # padded particle count (power-of-two multiple of L)
    leaf_size: int      # L
    depth: int          # number of levels below the root (leaves at `depth`)
    frontier: int       # max opened cells per level (W)
    theta_sqd: float    # geometric MAC opening angle^2
    quadrupole: bool = True
    fast: bool = False  # cell-centred Taylor far field (fast_* multipole)
    near_cap: int = 0   # max direct-interaction leaf cells per group (Wn)
    group_chunk: int = 32
    support_cap: int = 64   # max kernel-support cells per group (Ws)
    mac: str = "geometric"  # | "gadget2" | "eigenmac" (KDTree.cpp:824-843)
    macerror: float = 1e-4
    mp_cap: int = 0         # > 0: listed walk, width of the multipole lists
    # Per-level frontier caps (depth+1 ints; entry ell = padded frontier
    # width ENTERING level ell), measured by the native stats pass.  The
    # walk's gather/MAC/evaluate/compact work is proportional to each
    # level's padded width, so per-level sizing beats one global W by the
    # ratio sum(widths)/(depth * max).  None = size every level at
    # min(frontier, 2^ell).
    frontier_levels: tuple = None

    @property
    def n_leaves(self) -> int:
        return self.n_pad // self.leaf_size


# Pair slots of one vmapped chunk of walk groups: group_chunk groups of L
# targets against Wn*L near-field sources each.  At 1M (L = 32, Wn = 256)
# this gives 128 groups, the fastest of 32 / 64 / 128 measured on an H100
# (PERF.md).
GROUP_PAIR_BUDGET = 2 ** 25


def group_chunk_for(leaf_size: int, near_cap: int) -> int:
    """Walk groups per lax.map step, bounding the (Gc, L, Wn*L) near-field
    pair block to GROUP_PAIR_BUDGET slots."""
    return int(np.clip(GROUP_PAIR_BUDGET
                       // max(leaf_size * leaf_size * near_cap, 1), 8, 128))


def plan_tree(N: int, leaf_size: int = 32, frontier: int = None,
              theta_sqd: float = 0.1, quadrupole: bool = True,
              fast: bool = False, near_cap: int = None,
              group_chunk: int = None) -> TreeSpec:
    n_leaves = max(1, -(-N // leaf_size))
    n_leaves = 1 << int(np.ceil(np.log2(n_leaves)))
    if near_cap is None:
        # measured law for balanced KD buckets on jittered lattices:
        # worst-group near-field leaf count ~ 13 L at theta^2 = 0.1,
        # N-independent, scaling as 1/theta^3
        near_cap = int(13.0 * leaf_size
                       * (0.1 / max(theta_sqd, 1e-3)) ** 1.5) + 48
        near_cap = min(near_cap, n_leaves)
    if frontier is None:
        frontier = min(max(2 * near_cap, 64), 2 * n_leaves)
    if group_chunk is None:
        group_chunk = group_chunk_for(leaf_size, near_cap)
    return TreeSpec(n_pad=n_leaves * leaf_size, leaf_size=leaf_size,
                    depth=int(np.log2(n_leaves)), frontier=frontier,
                    theta_sqd=theta_sqd, quadrupole=quadrupole, fast=fast,
                    near_cap=near_cap, group_chunk=group_chunk)


def grow_tree_caps(spec: TreeSpec, factor: float = 1.6) -> TreeSpec:
    """Host-side cap growth after an overflow (the analogue of the
    reference's Nneibmax doubling, GradhSphTree.cpp:172-185).  Growth is
    monotone: the n_leaves bound must never SHRINK a cap below its
    current value (a shrink here rebounds at the next measured replan
    and thrashes recompiles)."""
    fl = spec.frontier_levels
    if fl is not None:
        fl = tuple(max(w, min(int(w * factor) + 16,
                              min(1 << ell, 2 * spec.n_leaves)))
                   for ell, w in enumerate(fl))
    return dataclasses.replace(
        spec,
        near_cap=max(spec.near_cap,
                     min(int(spec.near_cap * factor) + 8, spec.n_leaves)),
        frontier=max(spec.frontier,
                     min(int(spec.frontier * factor) + 16,
                         2 * spec.n_leaves)),
        support_cap=max(spec.support_cap,
                        min(int(spec.support_cap * factor) + 8,
                            spec.n_leaves)),
        frontier_levels=fl)


def morton_codes(r: Array, lo: Array, extent: Array, bits: int = 10) -> Array:
    """Interleaved-bit Morton codes on a 2^bits grid per dimension."""
    ndim = r.shape[1]
    scaled = jnp.clip((r - lo) / extent, 0.0, 1.0 - 1e-9)
    cells = (scaled * (1 << bits)).astype(jnp.uint32)
    code = jnp.zeros(r.shape[0], dtype=jnp.uint32)
    for b in range(bits):
        for k in range(ndim):
            bit = (cells[:, k] >> b) & 1
            code = code | (bit << (b * ndim + k))
    return code


class TreeLevels(NamedTuple):
    """Per-level cell properties, root (level 0) to leaves (level D).

    Lists of arrays indexed by level ell (each of length 2^ell):
    m, com (.., ndim), centre, half (bounding box), quad (.., ndim, ndim).
    """

    m: list
    com: list
    centre: list
    half: list
    quad: list


def build_tree(spec: TreeSpec, r_s: Array, m_s: Array,
               alive: Array) -> TreeLevels:
    """Bottom-up cell properties over Morton-SORTED padded arrays."""
    L = spec.leaf_size
    n_leaves = spec.n_leaves
    ndim = r_s.shape[1]
    big = 1e30

    # f32-safe masked divide: 1e-300 underflows to 0 in f32 and 0/0 = NaN
    # boxes would open EVERY cell in the walk (spurious overflow)
    far = 1e15
    def _div_com(num, den):
        safe = jnp.maximum(den, jnp.asarray(1e-30, den.dtype))
        return jnp.where((den > 0.0)[..., None], num / safe[..., None], far)

    alive_leaf = alive.reshape(n_leaves, L)
    m_leaf_p = jnp.where(alive, m_s, 0.0).reshape(n_leaves, L)
    r_leaf = r_s.reshape(n_leaves, L, ndim)
    m_tot = jnp.sum(m_leaf_p, axis=1)
    com = _div_com(jnp.sum(m_leaf_p[..., None] * r_leaf, axis=1), m_tot)
    rmin = jnp.min(jnp.where(alive_leaf[..., None], r_leaf, big), axis=1)
    rmax = jnp.max(jnp.where(alive_leaf[..., None], r_leaf, -big), axis=1)
    # empty leaves: collapse the box to a far sentinel so the walk's MAC
    # always accepts them (m = 0 excludes them as sources anyway) and an
    # empty TARGET group opens nothing
    empty = (m_tot <= 0.0)[..., None]
    rmin = jnp.where(empty, far, rmin)
    rmax = jnp.where(empty, far, rmax)

    if spec.quadrupole:
        # mask dead/padding slots BEFORE the outer product: padded slots sit
        # at huge coordinates and 0 * huge^2 would overflow f32 to NaN
        dr = jnp.where(alive_leaf[..., None], r_leaf - com[:, None, :], 0.0)
        q = jnp.einsum("lp,lpi,lpj->lij", m_leaf_p, dr, dr,
                       precision=_HIGHEST)
        tr = jnp.trace(q, axis1=-2, axis2=-1)
        q = 3.0 * q - tr[:, None, None] * jnp.eye(ndim)
    else:
        q = jnp.zeros((n_leaves, ndim, ndim), dtype=r_s.dtype)

    ms, coms, centres, halves, quads = [m_tot], [com], \
        [0.5 * (rmin + rmax)], [0.5 * (rmax - rmin)], [q]
    lo, hi = rmin, rmax
    # merge pairs up to the root
    for _ in range(spec.depth):
        m2 = ms[0].reshape(-1, 2)
        c2 = coms[0].reshape(-1, 2, ndim)
        mm = jnp.sum(m2, axis=1)
        cc = _div_com(jnp.sum(m2[..., None] * c2, axis=1), mm)
        # union only OCCUPIED children: empty-child sentinel boxes must not
        # inflate the parent box to the sentinel
        occ2 = (m2 > 0.0)[..., None]
        lo2 = jnp.min(jnp.where(occ2, lo.reshape(-1, 2, ndim), big), axis=1)
        hi2 = jnp.max(jnp.where(occ2, hi.reshape(-1, 2, ndim), -big),
                      axis=1)
        par_empty = (mm <= 0.0)[..., None]
        lo2 = jnp.where(par_empty, far, lo2)
        hi2 = jnp.where(par_empty, far, hi2)
        if spec.quadrupole:
            q2 = quads[0].reshape(-1, 2, ndim, ndim)
            # empty children sit at the far sentinel; mask their (zero-mass)
            # displacement so 0 * far^2 cannot overflow f32 to inf
            d = jnp.where(occ2, c2 - cc[:, None, :], 0.0)
            dq = jnp.einsum("lp,lpi,lpj->lij", m2, d, d,
                            precision=_HIGHEST)
            trdq = jnp.trace(dq, axis1=-2, axis2=-1)
            qq = jnp.sum(q2, axis=1) + 3.0 * dq \
                - trdq[:, None, None] * jnp.eye(ndim)
        else:
            qq = jnp.zeros((mm.shape[0], ndim, ndim), dtype=r_s.dtype)
        ms.insert(0, mm)
        coms.insert(0, cc)
        centres.insert(0, 0.5 * (lo2 + hi2))
        halves.insert(0, 0.5 * (hi2 - lo2))
        quads.insert(0, qq)
        lo, hi = lo2, hi2
    return TreeLevels(m=ms, com=coms, centre=centres, half=halves,
                      quad=quads)


def _ext_safe(extent, dtype) -> Array:
    """Periodic extent vector for min-image wrapping; 0 entries (open
    dims in mixed-periodicity Ewald mode) disable wrapping on that axis
    by mapping to a huge period."""
    L = jnp.asarray(extent, dtype)
    return jnp.where(L > 0, L, jnp.asarray(1e30, dtype))


def _safe_invr(drsqd: Array) -> Array:
    """1/|dr| that is 0 (not inf) at coincident points, with the clamp set
    so that inv_r^5 cannot overflow the dtype (masked cells multiply by
    m = 0, and 0 * inf would poison the sums with NaN)."""
    eps = 1e-24 if drsqd.dtype == jnp.float32 else 1e-60
    return jnp.where(drsqd > eps,
                     jax.lax.rsqrt(jnp.maximum(drsqd, eps)), 0.0)


def _multipole_accel(dr: Array, m: Array, quad: Array, quadrupole: bool):
    """Acceleration + potential from cells at displacement dr (= com - x)."""
    drsqd = jnp.sum(dr * dr, axis=-1)
    inv_r = _safe_invr(drsqd)
    inv_r3 = inv_r * inv_r * inv_r
    a = m[..., None] * dr * inv_r3[..., None]
    pot = m * inv_r
    if quadrupole:
        # traceless-quadrupole expansion (ComputeQuadropole,
        # NeighbourSearch.h:423-448; note the reference's dr = x - com is
        # the negative of ours, flipping the odd-order terms)
        inv_r5 = inv_r3 * inv_r * inv_r
        qdr = jnp.einsum("...ij,...j->...i", quad, dr, precision=_HIGHEST)
        drqdr = jnp.sum(qdr * dr, axis=-1)
        a = a - inv_r5[..., None] * qdr \
            + 2.5 * (drqdr * inv_r5 * inv_r * inv_r)[..., None] * dr
        pot = pot + 0.5 * drqdr * inv_r5
    return a, pot


def _compact(valid: Array, values: Array, cap: int, fill) -> tuple:
    """Compact `values[valid]` to the front of a (cap,) buffer (stable).

    Returns (compacted, count).  Entries beyond cap are dropped — the caller
    checks count > cap for overflow.  cumsum + scatter; no sort.
    """
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    count = pos[-1] + 1
    dest = jnp.where(valid, jnp.minimum(pos, cap - 1), cap)
    out = jnp.full((cap,), fill, dtype=values.dtype)
    out = out.at[dest].set(values, mode="drop")
    return out, count


class TreeGravityResult(NamedTuple):
    a: Array        # (n_pad, ndim), sorted order
    gpot: Array     # (n_pad,)


def tree_gravity(spec: TreeSpec, tree: TreeLevels,
                 r_s: Array, m_s: Array, alive: Array,
                 h_s: Array = None, kern=None, zh_s: Array = None,
                 group_range=None, zeta_scaling: str = "sph",
                 ewald_table=None, ewald_extent=None,
                 amag_s: Array = None, gpot_s: Array = None,
                 group_ids: Array = None,
                 mp_lists: Array = None, near_lists: Array = None):
    """Frontier-walk gravity for every particle (sorted order).

    Near-field (unopened leaf pairs) uses the reference's SYMMETRIC grad-h
    kernel-softened pair force when (h_s, kern) are given — including the
    zeta*hfactor*w1 grad-h correction terms when `zh_s` (= zeta * hfactor
    per particle) is provided (GradhSph::ComputeSphGravForces,
    src/GradhSph/GradhSph.cpp:598-656) — Newtonian otherwise.  Beyond
    kernel support the symmetric formula degenerates to the Newtonian sum,
    matching the direct oracle exactly.  Returns
    (TreeGravityResult, overflow bool).
    """
    L = spec.leaf_size
    W = spec.frontier
    Wn = spec.near_cap
    ndim = r_s.shape[1]
    n_leaves = spec.n_leaves
    theta_sqd = spec.theta_sqd
    dtype = r_s.dtype

    r_leaf = r_s.reshape(n_leaves, L, ndim)
    m_leaf = jnp.where(alive, m_s, 0.0).reshape(n_leaves, L)
    h_leaf = h_s.reshape(n_leaves, L) if h_s is not None else None
    zh_leaf = zh_s.reshape(n_leaves, L) if zh_s is not None else None
    # accuracy-MAC target-side factors (stocked per GROUP, the analogue
    # of the reference's per-cell amin/macfactor, KDTree.cpp:900-903):
    # gadget2 needs min |a_prev|; eigenmac needs max gpot^(-2/3)
    amin_leaf = macfac_leaf = None
    if spec.mac == "gadget2":
        big = jnp.asarray(1e30, dtype)
        amag = big if amag_s is None else jnp.where(alive, amag_s, big)
        amin_leaf = (jnp.full((n_leaves,), big) if amag_s is None
                     else jnp.min(amag.reshape(n_leaves, L), axis=1))
    elif spec.mac == "eigenmac":
        if gpot_s is None:
            macfac_leaf = jnp.zeros((n_leaves,), dtype)
        else:
            mf = jnp.where(alive & (gpot_s > 0.0),
                           jnp.maximum(gpot_s, 1e-30) ** (-2.0 / 3.0), 0.0)
            macfac_leaf = jnp.max(mf.reshape(n_leaves, L), axis=1)
    leaf_centre = tree.centre[-1]
    leaf_half = tree.half[-1]

    # All per-cell data is packed into ONE table per level (m | com |
    # half | upper-triangle quadrupole) and the leaf particles into one
    # (n_leaves, L, ndim+3) table: a single coalesced gather per level /
    # near list instead of four or five separate ones.
    tri = [(i, j) for i in range(ndim) for j in range(i, ndim)]
    nq = len(tri) if spec.quadrupole else 0
    levels_tab = []
    for ell in range(spec.depth + 1):
        cols = [tree.m[ell][:, None], tree.com[ell], tree.half[ell]]
        if spec.quadrupole:
            q = tree.quad[ell]
            cols.append(jnp.stack([q[:, i, j] for i, j in tri], -1))
        levels_tab.append(jnp.concatenate(cols, -1))
    pcols = [r_leaf, m_leaf[..., None]]
    pcols.append(h_leaf[..., None] if h_leaf is not None
                 else jnp.ones_like(m_leaf)[..., None])
    pcols.append(zh_leaf[..., None] if zh_leaf is not None
                 else jnp.zeros_like(m_leaf)[..., None])
    leaf_tab = jnp.concatenate(pcols, -1)        # (n_leaves, L, ndim+3)
    all_tab = None
    if mp_lists is not None:
        # listed-walk mode: one level-concatenated cell table whose row
        # (1 << ell) - 1 + c is cell c of level ell — the exact packed-id
        # layout the native tree_walk_lists pass emits
        all_tab = jnp.concatenate(levels_tab, axis=0)

    def _quad_terms(q6, dr):
        """qdr = Q.dr and dr.Q.dr from upper-triangle components."""
        qdr = []
        for i in range(ndim):
            acc = 0.0
            for j in range(ndim):
                a, b = (i, j) if i <= j else (j, i)
                acc = acc + q6[..., tri.index((a, b))] * dr[..., j]
            qdr.append(acc)
        qdr = jnp.stack(qdr, -1)
        return qdr, jnp.sum(qdr * dr, axis=-1)

    def _mp_accel(dr, m, q6):
        drsqd = jnp.sum(dr * dr, axis=-1)
        inv_r = _safe_invr(drsqd)
        inv_r3 = inv_r * inv_r * inv_r
        a = m[..., None] * dr * inv_r3[..., None]
        pot = m * inv_r
        if spec.quadrupole:
            inv_r5 = inv_r3 * inv_r * inv_r
            qdr, drqdr = _quad_terms(q6, dr)
            a = a - inv_r5[..., None] * qdr \
                + 2.5 * (drqdr * inv_r5 * inv_r * inv_r)[..., None] * dr
            pot = pot + 0.5 * drqdr * inv_r5
        return a, pot

    def walk_group(g):
        """Interaction list + far field for the L particles of leaf g."""
        rt = r_leaf[g]                                    # (L, ndim)
        gc = leaf_centre[g]
        gh = leaf_half[g]

        if spec.fast:
            a0 = jnp.zeros((ndim,), dtype)
            pot0 = jnp.zeros((), dtype)
            jac = jnp.zeros((ndim, ndim), dtype)
        else:
            a_acc = jnp.zeros((L, ndim), dtype)
            pot_acc = jnp.zeros((L,), dtype)

        front = jnp.zeros((1,), dtype=jnp.int32)   # level-0 root
        overflow = jnp.asarray(False)
        near_ids = jnp.full((Wn,), -1, dtype=jnp.int32)

        for ell in range(spec.depth + 1):
            # a level holds at most 2^ell cells — sizing every level's
            # frontier at W would waste most of the upper-level compute
            valid = front >= 0
            idx = jnp.maximum(front, 0)
            tab = levels_tab[ell][idx]                    # (W_ell, 1+2nd+nq)
            m_c = jnp.where(valid, tab[:, 0], 0.0)
            com_c = tab[:, 1:1 + ndim]
            half_c = tab[:, 1 + ndim:1 + 2 * ndim]
            q6 = tab[:, 1 + 2 * ndim:] if spec.quadrupole else None

            # geometric MAC (reference KDTree.cpp:824-843: open if
            # drsqd < rmax^2/theta^2).  Gap = worst-case distance from any
            # group particle to the cell COM; rmax = cell half-diagonal;
            # conservative for the whole group at once.
            if ewald_table is not None:
                _Lg = _ext_safe(ewald_extent, dtype)
            dsqd = jnp.zeros_like(m_c)
            rmax_sqd = jnp.zeros_like(m_c)
            for k_ in range(ndim):
                dk = tab[:, 1 + k_] - gc[k_]
                if ewald_table is not None:
                    # periodic walk geometry: a cell CLOSE through the
                    # seam must be opened (its multipole would otherwise
                    # be evaluated at an invalid min-image distance)
                    dk = dk - _Lg[k_] * jnp.round(dk / _Lg[k_])
                gap_k = jnp.maximum(jnp.abs(dk) - gh[k_], 0.0)
                dsqd = dsqd + gap_k * gap_k
                hk = tab[:, 1 + ndim + k_]
                rmax_sqd = rmax_sqd + hk * hk
            nonzero = m_c > 0.0
            accept = valid & nonzero & (dsqd * theta_sqd > rmax_sqd)
            if spec.mac == "gadget2":
                # open_cell_for_gravity gadget2 branch (Tree.h:424):
                # drsqd^2 * amin * macerror < rmax^2 * m
                extra = (dsqd * dsqd * amin_leaf[g] * spec.macerror
                         < rmax_sqd * m_c)
                accept = accept & ~extra
            elif spec.mac == "eigenmac" and spec.quadrupole:
                # source-cell error factor from the quadrupole eigenvalue
                # bound lambda = 2 sqrt(tr(Q^2)/6) for traceless Q
                # (KDTree.cpp:1058-1074), target factor max gpot^(-2/3)
                diag = sum(q6[..., tri.index((k_, k_))] ** 2
                           for k_ in range(ndim))
                offd = sum(q6[..., tri.index(p_)] ** 2
                           for p_ in tri if p_[0] != p_[1])
                trq2 = diag + 2.0 * offd
                lam = 2.0 * jnp.sqrt(jnp.maximum(trq2, 0.0) / 6.0)
                cellmac = (0.5 * lam / spec.macerror) ** (2.0 / 3.0)
                extra = dsqd < cellmac * macfac_leaf[g]
                accept = accept & ~extra
            open_ = valid & nonzero & ~accept

            m_a = jnp.where(accept, m_c, 0.0)
            if spec.quadrupole:
                q6 = jnp.where(accept[:, None], q6, 0.0)
            if spec.fast:
                dr = com_c - gc[None, :]                  # (W, ndim)
                if ewald_table is not None:
                    # the Ewald-corrected periodic sum is defined on the
                    # MIN-IMAGE separation; far cells' unwrapped dr can
                    # exceed the half-box
                    _L = _ext_safe(ewald_extent, dtype)
                    dr = dr - _L * jnp.round(dr / _L)
                a_f, p_f = _mp_accel(dr, m_a, q6)
                if ewald_table is not None:
                    # periodic correction at monopole level for accepted
                    # cells (Ewald.cpp:500 called from the cell loop)
                    from .ewald import ewald_correction

                    e_a, e_p = ewald_correction(ewald_table, dr)
                    a_f = a_f + m_a[:, None] * e_a
                    p_f = p_f + m_a * e_p
                a0 = a0 + jnp.sum(a_f, axis=0)
                pot0 = pot0 + jnp.sum(p_f, axis=0)
                # monopole acceleration Jacobian: d a_i / d x_j =
                # m (3 d_i d_j r^-5 - delta_ij r^-3)  (FastMultipoleForces,
                # NeighbourSearch.h:482-520)
                drsqd = jnp.sum(dr * dr, axis=-1)
                inv_r = _safe_invr(drsqd)
                inv_r3 = inv_r * inv_r * inv_r
                inv_r5 = inv_r3 * inv_r * inv_r
                outer = dr[:, :, None] * dr[:, None, :]
                jac = jac + jnp.sum(
                    m_a[:, None, None]
                    * (3.0 * outer * inv_r5[:, None, None]
                       - jnp.eye(ndim, dtype=dtype) * inv_r3[:, None, None]),
                    axis=0)
            else:
                dr = com_c[None, :, :] - rt[:, None, :]   # (L, W, ndim)
                if ewald_table is not None:
                    _L = _ext_safe(ewald_extent, dtype)
                    dr = dr - _L * jnp.round(dr / _L)
                a_f, p_f = _mp_accel(dr, m_a[None, :],
                                     q6[None] if q6 is not None else None)
                if ewald_table is not None:
                    from .ewald import ewald_correction

                    e_a, e_p = ewald_correction(ewald_table, dr)
                    a_f = a_f + m_a[None, :, None] * e_a
                    p_f = p_f + m_a[None, :] * e_p
                a_acc = a_acc + jnp.sum(a_f, axis=1)
                pot_acc = pot_acc + jnp.sum(p_f, axis=1)

            if ell < spec.depth:
                # expand opened cells into children; compact only once the
                # level could outgrow its width cap
                child0 = jnp.where(open_, 2 * idx, -1)
                child1 = jnp.where(open_, 2 * idx + 1, -1)
                kids = jnp.stack([child0, child1], axis=-1).reshape(-1)
                W_next = min(W, 2 ** (ell + 1))
                if spec.frontier_levels is not None:
                    W_next = min(W_next, spec.frontier_levels[ell + 1])
                if kids.shape[0] <= W_next:
                    front = kids
                else:
                    front, n_front = _compact(kids >= 0, kids, W_next,
                                              jnp.asarray(-1, jnp.int32))
                    overflow = overflow | (n_front > W_next)
            else:
                near_ids, n_near = _compact(open_, idx, Wn,
                                            jnp.asarray(-1, jnp.int32))
                overflow = overflow | (n_near > Wn)

        return _near_field(g, rt, gc, gh, near_ids, overflow,
                           (a0, pot0, jac) if spec.fast
                           else (a_acc, pot_acc))

    def walk_group_listed(g, mp_row, near_row):
        """Listed-walk far field: evaluate the host-emitted multipole cell
        list directly (one gather from the level-concatenated table), no
        frontier iteration.  The near list is likewise precomputed; the
        drift-skin MAC at plan time guarantees both stay valid while
        max per-particle drift <= margin (checked by the caller)."""
        rt = r_leaf[g]
        gc = leaf_centre[g]
        gh = leaf_half[g]
        valid = mp_row >= 0
        idx = jnp.maximum(mp_row, 0)
        tab = all_tab[idx]                           # (Wm, 1+2nd+nq)
        m_a = jnp.where(valid, tab[:, 0], 0.0)
        com_c = tab[:, 1:1 + ndim]
        q6 = None
        if spec.quadrupole:
            q6 = jnp.where(valid[:, None], tab[:, 1 + 2 * ndim:], 0.0)
        if spec.fast:
            dr = com_c - gc[None, :]                 # (Wm, ndim)
            a_f, p_f = _mp_accel(dr, m_a, q6)
            a0 = jnp.sum(a_f, axis=0)
            pot0 = jnp.sum(p_f, axis=0)
            drsqd = jnp.sum(dr * dr, axis=-1)
            inv_r = _safe_invr(drsqd)
            inv_r3 = inv_r * inv_r * inv_r
            inv_r5 = inv_r3 * inv_r * inv_r
            outer = dr[:, :, None] * dr[:, None, :]
            jac = jnp.sum(
                m_a[:, None, None]
                * (3.0 * outer * inv_r5[:, None, None]
                   - jnp.eye(ndim, dtype=dtype) * inv_r3[:, None, None]),
                axis=0)
            far = (a0, pot0, jac)
        else:
            dr = com_c[None, :, :] - rt[:, None, :]  # (L, Wm, ndim)
            a_f, p_f = _mp_accel(dr, m_a[None, :],
                                 q6[None] if q6 is not None else None)
            far = (jnp.sum(a_f, axis=1), jnp.sum(p_f, axis=1))
        return _near_field(g, rt, gc, gh, near_row, jnp.asarray(False),
                           far)

    def _near_field(g, rt, gc, gh, near_ids, overflow, far):
        """Near-field leaf pair block + kernel-support correction tier +
        far-field finalisation (shared by the frontier and listed walks).

        Two tiers: Newtonian over the FULL (L, Wn*L) block
        (cheap: one rsqrt per pair), kernel-softening CORRECTION only
        over the few cells within kernel support — beyond support the
        symmetric grad-h formula IS Newtonian, so the correction is
        exactly zero there and a conservative support selection loses
        nothing.

        Pair geometry is plain differences r_j - r_i: a particle meets
        itself (and any coincident twin) at exactly dr = 0, which both
        tiers mask."""
        if spec.fast:
            a0, pot0, jac = far
        else:
            a_acc, pot_acc = far
        nvalid = near_ids >= 0
        nidx = jnp.maximum(near_ids, 0)
        ntab = leaf_tab[nidx]                             # (Wn, L, nd+3)
        r_nb = ntab[..., :ndim].reshape(-1, ndim)         # (Wn*L, nd)
        m_nb = jnp.where(nvalid[:, None], ntab[..., ndim],
                         0.0).reshape(-1)
        drv = r_nb[None, :, :] - rt[:, None, :]           # (L, Wn*L, nd)
        if ewald_table is not None:
            # the periodic sum is defined on MIN-IMAGE separations
            _L = _ext_safe(ewald_extent, dtype)
            drv = drv - _L * jnp.round(drv / _L)
        dsq = jnp.sum(drv * drv, axis=-1)
        inv_d = _safe_invr(dsq)                           # 0 at dr = 0
        w_n = m_nb[None, :] * (inv_d * inv_d * inv_d)     # (L, Wn*L)
        a_n = jnp.sum(w_n[..., None] * drv, axis=1)
        p_n = jnp.sum(m_nb[None, :] * inv_d, axis=1)
        if ewald_table is not None:
            # tabulated per-pair periodic correction (Ewald.cpp:500 in
            # the particle-particle loop); self pairs carry none
            from .ewald import ewald_correction

            e_a, e_p = ewald_correction(ewald_table, drv)
            m_pair = jnp.where(dsq > 0.0, m_nb[None, :], 0.0)
            a_n = a_n + jnp.sum(m_pair[..., None] * e_a, axis=1)
            p_n = p_n + jnp.sum(m_pair * e_p, axis=1)

        if h_leaf is not None and kern is not None:
            # support-cell selection: cells whose box gap to the group box
            # could put any pair within kernrange * max(h_i, h_j).
            # h maxima use LIVE slots only — empty bucket slots carry the
            # h = 1.0 pad value, which would blow the support radius up to
            # the domain scale for any partially-filled bucket
            Ws = min(spec.support_cap, near_ids.shape[0])
            alive_g = alive.reshape(n_leaves, L)
            hg_max = jnp.max(jnp.where(alive_g[g], h_leaf[g], 0.0))
            hc_max = jnp.max(jnp.where(nvalid[:, None]
                                       & (ntab[..., ndim] > 0.0),
                                       ntab[..., ndim + 1], 0.0), axis=1)
            cc = leaf_centre[nidx]
            ch = leaf_half[nidx]
            dgc = cc - gc
            if ewald_table is not None:
                _Lg = _ext_safe(ewald_extent, dtype)
                dgc = dgc - _Lg * jnp.round(dgc / _Lg)
            gapv = jnp.maximum(jnp.abs(dgc) - ch - gh, 0.0)
            gap2 = jnp.sum(gapv * gapv, axis=-1)
            rad = kern.kernrange * jnp.maximum(hg_max, hc_max)
            in_support = nvalid & (gap2 < rad * rad)
            sup_ids, n_sup = _compact(in_support, nidx, Ws,
                                      jnp.asarray(-1, jnp.int32))
            overflow = overflow | (n_sup > Ws)

            svalid = sup_ids >= 0
            sidx = jnp.maximum(sup_ids, 0)
            stab = leaf_tab[sidx]                          # (Ws, L, nd+3)
            r_sb = stab[..., :ndim]
            m_sb = jnp.where(svalid[:, None], stab[..., ndim], 0.0)
            drs = r_sb[None, :, :, :] - rt[:, None, None, :]
            if ewald_table is not None:
                # keep the smoothed-pair images consistent with the
                # min-imaged near field
                _Ls = _ext_safe(ewald_extent, dtype)
                drs = drs - _Ls * jnp.round(drs / _Ls)
            dsqs = jnp.sum(drs * drs, axis=-1)
            selfp = dsqs <= 0.0
            # symmetric grad-h smoothed gravity (GradhSph.cpp:598-640):
            # paux = 0.5*[wgrav(s_i)/h_i^2 + zh_i*w1(s_i)
            #           + wgrav(s_j)/h_j^2 + zh_j*w1(s_j)]
            invh_t = (1.0 / h_leaf[g])[:, None, None]
            invh_nb = (1.0 / stab[..., ndim + 1])[None, :, :]
            dmag = jnp.sqrt(jnp.maximum(dsqs, 1e-300))
            s_t = dmag * invh_t
            s_nb = dmag * invh_nb
            paux = 0.5 * (invh_t * invh_t * kern.wgrav(s_t)
                          + invh_nb * invh_nb * kern.wgrav(s_nb))
            zcoef = None
            if zh_leaf is not None:
                zterm = 0.5 * (
                    zh_leaf[g][:, None, None] * kern.w1(s_t)
                    + stab[..., ndim + 2][None, :, :] * kern.w1(s_nb))
                if zeta_scaling == "sph":
                    # m_j * (zh_i w1_i + zh_j w1_j)
                    # (GradhSph.cpp:616-621)
                    paux = paux + zterm
                else:
                    # MFV: (1/m_i) * (zh_i w1_i + zh_j w1_j), NOT
                    # scaled by m_j (MfvCommon.cpp:413-416)
                    invm_t = 1.0 / jnp.maximum(m_leaf[g], 1e-30)
                    zcoef = jnp.where(selfp | (m_sb[None] <= 0.0), 0.0,
                                      invm_t[:, None, None] * zterm)
            gaux = 0.5 * (invh_t * kern.wpot(s_t)
                          + invh_nb * kern.wpot(s_nb))
            # subtract the Newtonian part already accumulated
            inv_ds = jnp.where(selfp, 0.0, _safe_invr(dsqs))
            coef = jnp.where(selfp, 0.0,
                             m_sb[None] * (paux / dmag - inv_ds ** 3))
            if zcoef is not None:
                coef = coef + zcoef / dmag
            a_n = a_n + jnp.sum(coef[..., None] * drs, axis=(1, 2))
            p_n = p_n + jnp.sum(
                jnp.where(selfp, 0.0, m_sb[None] * (gaux - inv_ds)),
                axis=(1, 2))

        if spec.fast:
            # Taylor expansion of the far field at each particle
            # (a = a0 + J.(r - gc); pot's gradient is the acceleration)
            delta = rt - gc[None, :]
            a_far = a0[None, :] + jnp.einsum("ij,pj->pi", jac, delta,
                                             precision=_HIGHEST)
            pot_far = pot0 + jnp.einsum("j,pj->p", a0, delta,
                                        precision=_HIGHEST)
            return a_far + a_n, pot_far + p_n, overflow
        return a_acc + a_n, pot_acc + p_n, overflow

    # group_ids walks an EXPLICIT (padded, -1 = skip) list of groups —
    # the block-timestep active-subset walk (only active buckets pay);
    # group_range=(start, count) walks a contiguous slice (the
    # distributed mode's per-shard share; start may be traced)
    if group_ids is not None:
        g_count = group_ids.shape[0]
        group_chunk = min(spec.group_chunk, g_count)
        n_chunks = -(-g_count // group_chunk)
        pad = n_chunks * group_chunk - g_count
        gids_flat = jnp.concatenate(
            [jnp.maximum(group_ids, 0),
             jnp.zeros((pad,), group_ids.dtype)])
        gids = gids_flat.reshape(n_chunks, group_chunk)
        a, pot, overflow = jax.lax.map(jax.vmap(walk_group), gids)
        a = a.reshape(-1, L, ndim)[:g_count]
        pot = pot.reshape(-1, L)[:g_count]
        valid = group_ids >= 0
        a = jnp.where(valid[:, None, None], a, 0.0)
        pot = jnp.where(valid[:, None], pot, 0.0)
        return TreeGravityResult(a=a.reshape(g_count * L, ndim),
                                 gpot=pot.reshape(g_count * L)), \
            jnp.any(overflow)
    if group_range is None:
        g_start, g_count = 0, n_leaves
    else:
        g_start, g_count = group_range
    group_chunk = min(spec.group_chunk, g_count)
    n_chunks = -(-g_count // group_chunk)
    gids = jnp.arange(n_chunks * group_chunk, dtype=jnp.int32) % g_count \
        + jnp.asarray(g_start, jnp.int32)
    gids = gids.reshape(n_chunks, group_chunk)
    if mp_lists is not None:
        chunk_fn = lambda gc_: jax.vmap(walk_group_listed)(
            gc_, mp_lists[gc_], near_lists[gc_])
    else:
        chunk_fn = lambda gc_: jax.vmap(walk_group)(gc_)
    a, pot, overflow = jax.lax.map(chunk_fn, gids)
    a = a.reshape(-1, L, ndim)[:g_count]
    pot = pot.reshape(-1, L)[:g_count]
    return TreeGravityResult(a=a.reshape(g_count * L, ndim),
                             gpot=pot.reshape(g_count * L)), \
        jnp.any(overflow)


def _morton_codes_np(r: np.ndarray, bits: int) -> np.ndarray:
    N, ndim = r.shape
    lo = r.min(axis=0)
    extent = np.maximum(r.max(axis=0) - lo, 1e-30)
    scaled = np.clip((r - lo) / extent, 0.0, 1.0 - 1e-9)
    cells = (scaled * (1 << bits)).astype(np.uint64)
    code = np.zeros(N, dtype=np.uint64)
    for b in range(bits):
        for k in range(ndim):
            code |= ((cells[:, k] >> np.uint64(b)) & np.uint64(1)) \
                << np.uint64(b * ndim + k)
    return code


def plan_buckets(r: np.ndarray, leaf_size: int, bits: int = 10) -> np.ndarray:
    """Host-side bucket planning (per tree-rebuild cadence, the analogue of
    KDTree::BuildTree every ntreebuildstep, HydroTree.cpp:310).

    Particles are Morton-sorted and split at OCTANT boundaries until every
    run holds <= leaf_size particles, then consecutive runs are greedily
    re-packed up to leaf_size.  Every bucket is therefore a compact spatial
    box (unlike fixed-count chunks of the curve, which can straddle major
    Morton jumps and produce domain-spanning leaf boxes that blow up the
    MAC's near-field lists).

    Returns gather map (G_pad, leaf_size) int32, -1 = empty slot; G_pad is a
    power of two (empty buckets at the tail).
    """
    N, ndim = r.shape
    code = _morton_codes_np(np.asarray(r, np.float64), bits)
    order = np.argsort(code, kind="stable")
    cs = code[order]
    total_bits = bits * ndim
    nchild = 1 << ndim

    # level-synchronous octant splitting (vectorised searchsorted)
    starts, ends = np.array([0], np.int64), np.array([N], np.int64)
    leaf_s, leaf_e = [], []
    for lev in range(1, bits + 1):
        big = (ends - starts) > leaf_size
        if not big.any():
            leaf_s.append(starts)
            leaf_e.append(ends)
            break
        leaf_s.append(starts[~big])
        leaf_e.append(ends[~big])
        bs, be = starts[big], ends[big]
        shift = np.uint64(total_bits - ndim * lev)
        parent = (cs[bs] >> shift) >> np.uint64(ndim)
        child_lo = ((parent[:, None] << np.uint64(ndim))
                    + np.arange(nchild, dtype=np.uint64)[None, :]) << shift
        bounds = np.searchsorted(cs, child_lo.ravel()).reshape(-1, nchild)
        starts = bounds.ravel()
        ends = np.concatenate([bounds[:, 1:], be[:, None]],
                              axis=1).ravel()
        keep = ends > starts
        starts, ends = starts[keep], ends[keep]
        if lev == bits and len(starts):
            # code collisions deeper than the grid: chop into L-sized chunks
            for s, e in zip(starts, ends):
                for c in range(int(s), int(e), leaf_size):
                    leaf_s.append(np.array([c]))
                    leaf_e.append(np.array([min(c + leaf_size, int(e))]))
            starts = ends = np.array([], np.int64)
    leaf_s = np.concatenate(leaf_s) if leaf_s else np.array([0])
    leaf_e = np.concatenate(leaf_e) if leaf_e else np.array([N])
    o = np.argsort(leaf_s)
    leaf_s, leaf_e = leaf_s[o], leaf_e[o]

    # greedy packing of consecutive octant runs up to leaf_size
    counts = leaf_e - leaf_s
    cum = np.concatenate([[0], np.cumsum(counts)])
    g_starts = []
    i = 0
    n_runs = len(counts)
    while i < n_runs:
        g_starts.append(i)
        # last run index whose cumulative count still fits in leaf_size
        j = np.searchsorted(cum, cum[i] + leaf_size, side="right") - 1
        i = max(j, i + 1)
    G = len(g_starts)
    g_starts.append(n_runs)
    G_pad = 1 << int(np.ceil(np.log2(max(G, 1))))
    gmap = np.full((G_pad, leaf_size), -1, np.int32)
    for gi in range(G):
        s = leaf_s[g_starts[gi]]
        e = leaf_e[g_starts[gi + 1] - 1]
        gmap[gi, : e - s] = order[s:e]
    return gmap
def walk_stats_native(r: np.ndarray, gmap: np.ndarray, theta_sqd: float,
                      m: np.ndarray = None, h: np.ndarray = None,
                      kernrange: float = 2.0, sample: int = 2048):
    """Measured walk statistics via the C++ planner: the worst frontier
    width, near-field leaf count and kernel-support leaf count the CURRENT
    particle distribution actually needs (same MAC as the device walk).

    Returns (near_max, front_max, sup_max) or None when the native library
    is unavailable (callers fall back to the worst-case cap law)."""
    from ..native import load as _load_native

    lib = _load_native()
    if lib is None:
        return None
    G_pad, L = gmap.shape
    r_c = np.ascontiguousarray(r, dtype=np.float64)
    g_c = np.ascontiguousarray(gmap, dtype=np.int32)
    m_c = (np.ascontiguousarray(m, dtype=np.float64)
           if m is not None else None)
    h_c = (np.ascontiguousarray(h, dtype=np.float64)
           if h is not None else None)
    out = np.zeros(3, dtype=np.int32)
    rc = lib.tree_walk_stats(
        r_c.ctypes.data,
        m_c.ctypes.data if m_c is not None else None,
        h_c.ctypes.data if h_c is not None else None,
        r_c.shape[0], r_c.shape[1], g_c.ctypes.data, G_pad, L,
        float(theta_sqd), float(kernrange), int(sample), out.ctypes.data)
    if rc != 0:
        return None
    return int(out[0]), int(out[1]), int(out[2])


def walk_stats_levels_native(r: np.ndarray, gmap: np.ndarray,
                             theta_sqd: float, m: np.ndarray = None,
                             h: np.ndarray = None, kernrange: float = 2.0,
                             sample: int = 2048):
    """Like walk_stats_native but additionally returns the per-level
    frontier maxima (np.int32 array of depth+1 entries — the width
    entering each level), for per-level frontier sizing.  Returns
    (near_max, front_max, sup_max, level_maxima) or None."""
    from ..native import load as _load_native

    lib = _load_native()
    if lib is None or not hasattr(lib, "tree_walk_stats_levels"):
        return None
    G_pad, L = gmap.shape
    depth = int(np.log2(G_pad))
    r_c = np.ascontiguousarray(r, dtype=np.float64)
    g_c = np.ascontiguousarray(gmap, dtype=np.int32)
    m_c = (np.ascontiguousarray(m, dtype=np.float64)
           if m is not None else None)
    h_c = (np.ascontiguousarray(h, dtype=np.float64)
           if h is not None else None)
    out = np.zeros(3, dtype=np.int32)
    out_levels = np.zeros(depth + 1, dtype=np.int32)
    rc = lib.tree_walk_stats_levels(
        r_c.ctypes.data,
        m_c.ctypes.data if m_c is not None else None,
        h_c.ctypes.data if h_c is not None else None,
        r_c.shape[0], r_c.shape[1], g_c.ctypes.data, G_pad, L,
        float(theta_sqd), float(kernrange), int(sample), out.ctypes.data,
        out_levels.ctypes.data)
    if rc != 0:
        return None
    return int(out[0]), int(out[1]), int(out[2]), out_levels


def plan_buckets_kd(r: np.ndarray, leaf_size: int) -> np.ndarray:
    """Host-side balanced KD bucket planner (the reference KDTree's
    longest-axis median split, KDTree.cpp:442-595, done level-synchronously
    with one lexsort per level instead of recursive QuickSelect).

    Splits until every bucket holds <= leaf_size particles.  Buckets are
    DISJOINT tight boxes with occupancy in (leaf_size/2, leaf_size], which
    keeps the walk's near-field lists small — Morton-run packing produced
    overlapping boxes whose near fields blew up ~4x.

    Returns gather map (G_pad, leaf_size) int32, -1 = empty; G_pad is the
    number of buckets padded to a power of two.

    Uses the C++ planner (gandalf_tpu/native/kdplan.cpp) when available —
    much faster than the numpy fallback.
    """
    N, ndim = r.shape
    from ..native import load as _load_native

    lib = _load_native()
    if lib is not None and ndim <= 16:
        r_c = np.ascontiguousarray(r, dtype=np.float64)
        # upper bound on buckets: every split is at worst (ceil, floor)
        g_max = 1
        while g_max * leaf_size < 2 * N + leaf_size:
            g_max *= 2
        gmap = np.full((g_max, leaf_size), -1, np.int32)
        n_used = lib.kd_plan_buckets(
            r_c.ctypes.data, N, ndim, leaf_size,
            gmap.ctypes.data, g_max)
        if n_used > 0:
            G_pad = 1 << int(np.ceil(np.log2(max(n_used, 1))))
            return np.ascontiguousarray(gmap[:G_pad])
    seg = np.zeros(N, dtype=np.int64)      # bucket id (sorted, compact)
    order = np.arange(N)
    r_work = r
    idx = np.arange(N)
    for _ in range(64):                    # safety bound >> log2(N)
        # compress ids (keeps seg sorted) and find oversized segments
        _, seg = np.unique(seg, return_inverse=True)
        counts = np.bincount(seg)
        if counts.max() <= leaf_size:
            break
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        lo = np.minimum.reduceat(r_work, starts, axis=0)
        hi = np.maximum.reduceat(r_work, starts, axis=0)
        axis = np.argmax(hi - lo, axis=1)              # (n_seg,)
        key = r_work[idx, axis[seg]]
        o = np.lexsort((key, seg))
        seg = seg[o]
        order = order[o]
        r_work = r_work[o]
        pos = idx - starts[seg]
        split = (counts > leaf_size)[seg]
        child = (split & (pos >= (counts[seg] + 1) // 2)).astype(np.int64)
        seg = 2 * seg + child
    counts = np.bincount(seg)
    assert counts.max() <= leaf_size, (counts.max(), leaf_size)
    n_seg = len(counts)
    G_pad = 1 << int(np.ceil(np.log2(max(n_seg, 1))))
    gmap = np.full((G_pad, leaf_size), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = idx - starts[seg]
    gmap[seg, pos] = order
    return gmap


def plan_tree_for_buckets(gmap: np.ndarray, theta_sqd: float = 0.1,
                          quadrupole: bool = True, fast: bool = False,
                          near_cap: int = None,
                          frontier: int = None, mac: str = "geometric",
                          macerror: float = 1e-4) -> TreeSpec:
    """TreeSpec matching a plan_buckets gather map."""
    G_pad, L = gmap.shape
    spec = plan_tree(G_pad * L, leaf_size=L, theta_sqd=theta_sqd,
                     quadrupole=quadrupole or mac == "eigenmac",
                     fast=fast, near_cap=near_cap,
                     frontier=frontier)
    assert spec.n_pad == G_pad * L, (spec.n_pad, gmap.shape)
    return dataclasses.replace(spec, mac=mac, macerror=macerror)


def unwrap_to_buckets(spec: TreeSpec, r_s: Array, in_map: Array,
                      periodic_extent) -> Array:
    """Per-bucket min-image unwrapping for periodic domains: a particle
    that wrapped across the box seam since the buckets were planned would
    otherwise inflate its bucket's bounding box to the whole domain (the
    walk then opens every cell and overflows).  Each bucket's first slot
    anchors the images; the bucket cloud stays contiguous at the cost of
    evaluating seam particles at a neighbouring image — consistent with
    the isolated-box (ewald = 0) gravity model."""
    L = spec.leaf_size
    n_leaves = spec.n_leaves
    ndim = r_s.shape[1]
    ext = jnp.asarray(periodic_extent, r_s.dtype)       # (ndim,), 0 = open
    r_g = r_s.reshape(n_leaves, L, ndim)
    # anchor on the first REAL slot: pad slots sit at the 1e15 sentinel,
    # where float spacing (~0.125) would quantise the whole bucket
    in_g = in_map.reshape(n_leaves, L)
    first = jnp.argmax(in_g, axis=1)                    # 0 if none real
    anchor = jnp.take_along_axis(r_g, first[:, None, None]
                                 .repeat(ndim, axis=2), axis=1)
    delta = r_g - anchor
    wrapped = delta - ext * jnp.round(
        jnp.where(ext > 0, delta / jnp.where(ext > 0, ext, 1.0), 0.0))
    out = (anchor + wrapped).reshape(-1, ndim)
    return jnp.where(in_map[:, None], out, r_s)


def unwrap_to_anchors(spec: TreeSpec, r_s: Array, in_map: Array,
                      anchors: Array, periodic_extent) -> Array:
    """unwrap_to_buckets with FIXED plan-time anchors: the listed walk's
    bucket frames must not jump when a live anchor particle crosses the
    periodic seam (a frame jump displaces the whole bucket by the box
    length relative to the cached interaction lists), so images are taken
    around the anchors captured at plan time."""
    L = spec.leaf_size
    n_leaves = spec.n_leaves
    ndim = r_s.shape[1]
    ext = jnp.asarray(periodic_extent, r_s.dtype)
    r_g = r_s.reshape(n_leaves, L, ndim)
    delta = r_g - anchors[:, None, :]
    wrapped = delta - ext * jnp.round(
        jnp.where(ext > 0, delta / jnp.where(ext > 0, ext, 1.0), 0.0))
    out = (anchors[:, None, :] + wrapped).reshape(-1, ndim)
    return jnp.where(in_map[:, None], out, r_s)


class WalkLists(NamedTuple):
    """Host-planned interaction lists (drift-skin cached walk)."""

    mp: np.ndarray       # (G_pad, Wm) int32 packed cell ids, -1 padded
    near: np.ndarray     # (G_pad, Wn) int32 leaf ids, -1 padded
    sup_max: int         # measured kernel-support leaf demand (cap sizing)
    r_plan: np.ndarray   # (N, ndim) unwrapped plan positions
    anchors: np.ndarray  # (n_leaves, ndim) bucket unwrap anchors
    margin: float        # drift skin the lists stay valid within


def plan_walk_lists(gmap: np.ndarray, r: np.ndarray, m: np.ndarray = None,
                    h: np.ndarray = None, theta_sqd: float = 0.1,
                    kernrange: float = 2.0, margin: float = 0.0,
                    periodic_extent=None, mp_floor: int = 0,
                    near_floor: int = 0):
    """Host-side interaction-list planning (per tree-rebuild cadence):
    walks the implicit tree once per group with the margin-deflated MAC
    (native tree_walk_lists; the Verlet-list skin technique applied to
    the BH acceptance criterion) and returns per-group multipole/near
    lists that the device evaluates directly — replacing the in-jit
    frontier walk of the reference's per-step
    Tree::ComputeGravityInteractionAndGhostList (src/Tree/Tree.cpp:628).

    Returns None when the native library is unavailable (callers fall
    back to the frontier walk).  mp_floor/near_floor are hysteresis
    floors: measured demand below an old cap keeps the old cap so the
    padded shapes (and the compiled step) stay stable across replans."""
    from ..native import load as _load_native

    lib = _load_native()
    if lib is None or not hasattr(lib, "tree_walk_lists"):
        return None
    G_pad, L = gmap.shape
    N, ndim = r.shape
    r64 = np.ascontiguousarray(r, np.float64)
    # per-bucket periodic unwrap around the first-real-slot anchor, in
    # ORIGINAL particle order (each particle sits in exactly one bucket)
    flat = gmap.reshape(-1)
    in_map = flat >= 0
    safe = np.maximum(flat, 0)
    r_g = np.where(in_map[:, None], r64[safe], 1e15).reshape(
        G_pad, L, ndim)
    first = np.argmax(in_map.reshape(G_pad, L), axis=1)
    anchors = r_g[np.arange(G_pad), first]
    if periodic_extent is not None:
        ext = np.asarray(periodic_extent, np.float64)
        r_unw = r64.copy()
        delta = r_g - anchors[:, None, :]
        wdelta = delta - np.where(ext > 0, ext, 1.0) * np.round(
            np.where(ext > 0, delta / np.where(ext > 0, ext, 1.0), 0.0))
        unw = (anchors[:, None, :] + wdelta).reshape(-1, ndim)
        pid = flat[in_map]
        r_unw[pid] = unw[in_map]
    else:
        r_unw = r64
    g_c = np.ascontiguousarray(gmap, np.int32)
    r_c = np.ascontiguousarray(r_unw)
    m_c = np.ascontiguousarray(m, np.float64) if m is not None else None
    h_c = np.ascontiguousarray(h, np.float64) if h is not None else None
    counts = np.zeros(3, np.int32)

    def _walk(mp_cap, near_cap, mp_buf, near_buf):
        return lib.tree_walk_lists(
            r_c.ctypes.data,
            m_c.ctypes.data if m_c is not None else None,
            h_c.ctypes.data if h_c is not None else None,
            N, ndim, g_c.ctypes.data, G_pad, L, float(theta_sqd),
            float(kernrange), float(margin), mp_cap, near_cap,
            mp_buf.ctypes.data if mp_buf is not None else None,
            near_buf.ctypes.data if near_buf is not None else None,
            counts.ctypes.data)

    if mp_floor > 0 and near_floor > 0:
        # steady-state shortcut: the fill pass measures true demand as it
        # fills, so when the previous caps still hold the whole walk runs
        # ONCE (the rebuild-cadence replan is host-serial and sits on the
        # step's critical path — this halves it).  Caps only shrink on an
        # overflow-triggered full replan, which is the cap-monotone policy
        # the overflow path already applies.
        mp = np.empty((G_pad, mp_floor), np.int32)
        near = np.empty((G_pad, near_floor), np.int32)
        if _walk(mp_floor, near_floor, mp, near) != 0:
            return None
        if int(counts[0]) <= mp_floor and int(counts[1]) <= near_floor:
            # List widths are deliberately MONOTONE for the run (ADVICE
            # r4 considered a shrink-on-collapse fall-through): a width
            # change means new padded shapes, i.e. a full XLA recompile
            # landing on the rebuild-cadence critical path, while
            # oversized widths only cost masked -1 slots.  A demand collapse big enough to
            # matter coincides with an overflow-triggered full replan
            # anyway (cap-monotone growth policy), which re-measures.
            return WalkLists(mp=mp, near=near, sup_max=int(counts[2]),
                             r_plan=r_unw, anchors=anchors,
                             margin=float(margin))
    rc = _walk(0, 0, None, None)
    if rc != 0:
        return None
    mp_max, near_max, sup_max = (int(c) for c in counts)
    q32 = lambda x: max(-(-int(x) // 32) * 32, 32)

    def _cap(measured, floor):
        # same hysteresis law as the frontier caps (_settle): keep the
        # old cap while demand fits within [cap, 4*cap]; on growth
        # overshoot by 25% of the old cap so steadily-rising demand (a
        # collapsing core) doesn't recompile at every rebuild cadence
        cap = q32(measured)
        if floor:
            if measured <= floor <= 4 * cap:
                return floor
            if cap > floor:
                return q32(max(cap, int(1.25 * floor)))
        return cap

    mp_cap = _cap(mp_max, mp_floor)
    near_cap = _cap(near_max, near_floor)
    mp = np.empty((G_pad, mp_cap), np.int32)
    near = np.empty((G_pad, near_cap), np.int32)
    if _walk(mp_cap, near_cap, mp, near) != 0:
        return None
    return WalkLists(mp=mp, near=near, sup_max=sup_max, r_plan=r_unw,
                     anchors=anchors, margin=float(margin))


def tree_gravity_listed(spec: TreeSpec, gmap: Array, mp_lists: Array,
                        near_lists: Array, r_plan: Array, anchors: Array,
                        margin: float, r: Array, m: Array,
                        h: Array = None, kern=None, alive: Array = None,
                        zh: Array = None, periodic_extent=None,
                        zeta_scaling: str = "sph"):
    """Gravity over host-planned interaction lists (plan_walk_lists):
    stock multipoles from live positions, evaluate each group's cached
    multipole/near lists, and flag overflow when any particle drifted
    beyond the plan margin (the Verlet-skin validity criterion — the
    caller replans exactly as for a frontier-cap overflow).

    Geometric MAC only; the frontier walk remains the path for Ewald,
    accuracy MACs and active-subset (block-timestep) walks."""
    N, ndim = r.shape
    flat = gmap.reshape(-1)
    safe = jnp.maximum(flat, 0)
    in_map = flat >= 0
    r_s = jnp.where(in_map[:, None], r[safe], 1e15)
    plan_rs = jnp.where(in_map[:, None], r_plan[safe], 1e15)
    if periodic_extent is not None:
        r_s = unwrap_to_anchors(spec, r_s, in_map, anchors,
                                periodic_extent)
    m_s = jnp.where(in_map, m[safe], 0.0)
    alive_s = in_map if alive is None else in_map & alive[safe]
    # drift-skin validity: lists hold while every LIVE particle stays
    # within margin of its plan position (dead particles drop to m = 0
    # and cannot invalidate an acceptance)
    drift = jnp.where(alive_s[:, None], jnp.abs(r_s - plan_rs), 0.0)
    drift_ovf = jnp.max(drift) > margin
    h_s = zh_s = None
    if h is not None:
        h_s = jnp.where(in_map, h[safe], 1.0)
    if zh is not None:
        zh_s = jnp.where(in_map, zh[safe], 0.0)
    tree = build_tree(spec, r_s, m_s, alive_s)
    res, overflow = tree_gravity(spec, tree, r_s, m_s, alive_s, h_s, kern,
                                 zh_s, zeta_scaling=zeta_scaling,
                                 mp_lists=mp_lists, near_lists=near_lists)
    a = jnp.zeros((N, ndim), r.dtype).at[safe].add(
        jnp.where(in_map[:, None], res.a, 0.0))
    gpot = jnp.zeros((N,), r.dtype).at[safe].add(
        jnp.where(in_map, res.gpot, 0.0))
    return a, gpot, overflow | drift_ovf


def tree_gravity_grouped(spec: TreeSpec, gmap: Array, r: Array, m: Array,
                         h: Array = None, kern=None, alive: Array = None,
                         zh: Array = None, periodic_extent=None,
                         zeta_scaling: str = "sph", ewald_table=None,
                         amag=None, gpot_prev=None):
    """Gravity with host-planned buckets: gather into bucket order (static
    map, no in-jit sort), stock boxes from CURRENT positions, walk, scatter
    back.  Returns (a, gpot, overflow) in ORIGINAL particle order."""
    N, ndim = r.shape
    flat = gmap.reshape(-1)
    safe = jnp.maximum(flat, 0)
    in_map = flat >= 0
    r_s = jnp.where(in_map[:, None], r[safe], 1e15)
    if periodic_extent is not None:
        r_s = unwrap_to_buckets(spec, r_s, in_map, periodic_extent)
    m_s = jnp.where(in_map, m[safe], 0.0)
    alive_s = in_map if alive is None else in_map & alive[safe]
    h_s = zh_s = amag_s = gpot_s = None
    if h is not None:
        h_s = jnp.where(in_map, h[safe], 1.0)
    if zh is not None:
        zh_s = jnp.where(in_map, zh[safe], 0.0)
    if amag is not None:
        amag_s = jnp.where(in_map, amag[safe], 1e30)
    if gpot_prev is not None:
        gpot_s = jnp.where(in_map, gpot_prev[safe], 0.0)
    tree = build_tree(spec, r_s, m_s, alive_s)
    res, overflow = tree_gravity(spec, tree, r_s, m_s, alive_s, h_s, kern,
                                 zh_s, zeta_scaling=zeta_scaling,
                                 ewald_table=ewald_table,
                                 ewald_extent=periodic_extent,
                                 amag_s=amag_s, gpot_s=gpot_s)
    a = jnp.zeros((N, ndim), r.dtype).at[safe].add(
        jnp.where(in_map[:, None], res.a, 0.0))
    gpot = jnp.zeros((N,), r.dtype).at[safe].add(
        jnp.where(in_map, res.gpot, 0.0))
    return a, gpot, overflow


def tree_gravity_all(spec: TreeSpec, r: Array, m: Array,
                     h: Array = None, kern=None, alive: Array = None,
                     zh: Array = None):
    """Convenience wrapper: sort -> build -> walk -> unsort.

    Returns (a, gpot, overflow) in ORIGINAL particle order.
    """
    N = r.shape[0]
    ndim = r.shape[1]
    lo = jnp.min(r, axis=0)
    extent = jnp.maximum(jnp.max(r, axis=0) - lo, 1e-30)
    codes = morton_codes(r, lo, extent)
    order = jnp.argsort(codes)
    pad = spec.n_pad - N
    r_s = jnp.concatenate([r[order], jnp.full((pad, ndim), 1e15,
                                              dtype=r.dtype)])
    m_s = jnp.concatenate([m[order], jnp.zeros((pad,), dtype=m.dtype)])
    alive_n = jnp.ones((N,), bool) if alive is None else alive[order]
    alive_s = jnp.concatenate([alive_n, jnp.zeros((pad,), bool)])
    h_s = zh_s = None
    if h is not None:
        h_s = jnp.concatenate([h[order], jnp.ones((pad,), dtype=h.dtype)])
    if zh is not None:
        zh_s = jnp.concatenate([zh[order],
                                jnp.zeros((pad,), dtype=zh.dtype)])
    tree = build_tree(spec, r_s, m_s, alive_s)
    res, overflow = tree_gravity(spec, tree, r_s, m_s, alive_s, h_s, kern,
                                 zh_s)
    inv = jnp.zeros_like(order).at[order].set(
        jnp.arange(N, dtype=order.dtype))
    return res.a[:N][inv], res.gpot[:N][inv], overflow


def tree_gravity_active(spec: TreeSpec, gmap: Array, r: Array, m: Array,
                        h: Array = None, kern=None, alive: Array = None,
                        zh: Array = None, group_ids: Array = None,
                        periodic_extent=None):
    """Bucket-planned gravity for an EXPLICIT active-group subset (the
    block-timestep walk: only buckets containing active particles pay,
    Simulation.cpp:1763-2197 + the reference's active-cell force walks).

    group_ids: (G_cap,) leaf ids, -1 padding.  Returns (a, gpot,
    overflow) in ORIGINAL particle order; rows of inactive groups are
    zero."""
    N, ndim = r.shape
    flat = gmap.reshape(-1)
    safe = jnp.maximum(flat, 0)
    in_map = flat >= 0
    r_s = jnp.where(in_map[:, None], r[safe], 1e15)
    if periodic_extent is not None:
        r_s = unwrap_to_buckets(spec, r_s, in_map, periodic_extent)
    m_s = jnp.where(in_map, m[safe], 0.0)
    alive_s = in_map if alive is None else in_map & alive[safe]
    h_s = zh_s = None
    if h is not None:
        h_s = jnp.where(in_map, h[safe], 1.0)
    if zh is not None:
        zh_s = jnp.where(in_map, zh[safe], 0.0)
    tree = build_tree(spec, r_s, m_s, alive_s)
    res, overflow = tree_gravity(spec, tree, r_s, m_s, alive_s, h_s,
                                 kern, zh_s, group_ids=group_ids)
    L = spec.leaf_size
    rows = gmap[jnp.maximum(group_ids, 0)]            # (G_cap, L)
    valid = (group_ids >= 0)[:, None] & (rows >= 0)
    ids = jnp.maximum(rows, 0).reshape(-1)
    a = jnp.zeros((N, ndim), r.dtype).at[ids].add(
        jnp.where(valid.reshape(-1)[:, None], res.a, 0.0))
    gpot = jnp.zeros((N,), r.dtype).at[ids].add(
        jnp.where(valid.reshape(-1), res.gpot, 0.0))
    return a, gpot, overflow
