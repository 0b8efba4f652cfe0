"""Locally-essential-tree (LET) distributed Barnes-Hut gravity.

Memory-scalable replacement for the replicated distributed gravity in
`parallel/dist.py:dist_tree_gravity` (which all_gathers every particle,
builds the full tree on every shard, and psums O(N_total) arrays).  The
SPMD analogue of the reference's pruned trees + export/return
force dance (HydroTree::BuildPrunedTree /root/reference/src/Tree/
HydroTree.cpp:1044-1238, StockPrunedTree :1240, UpdateGravityExportList
:777, MpiControl export/return :745-910):

- each shard KD-bucket-sorts ITS OWN z-slab only (host-planned gather
  map, like the single-chip path),
- ring neighbours up to radius R exchange their RAW bucket-sorted
  blocks via lax.ppermute; R is chosen at plan time as the smallest
  ring distance beyond which leaf-bucket summaries pass the geometric
  MAC for any target in this slab (R = ceil(rmax_leaf/(theta*w_slab)),
  also covering kernel support for the smoothed-gravity correction).
  At production N/S this is R = 1,
- the shard builds ONE tree over the (2R+1) raw slabs (they concatenate
  into a valid bucket ordering: slabs are z-ordered, buckets KD-ordered
  within each) and runs the standard near/far walk for its own G_loc
  target groups only — cross-seam kernel-softened pairs come out exact,
- every shard publishes (all_gather) a packed summary of ALL levels of
  its local tree — (2^(depth+1)-1) cells x (m|com|half|quad), a few
  hundred KB — and shards beyond the ring radius are evaluated by a
  MAC-checked frontier walk of their published summaries (multipole
  only; a leaf-level MAC failure sets the overflow flag, which triggers
  a host replan with R+1, mirroring the grid path's cap growth).

Per-device memory is O((2R+1) N/S + S 2^depth/... summaries): nothing
O(N_total) is ever materialised, and the O(N_total) psum force-return
of the old path disappears (each shard computes exactly its own
particles' total force).  When 2R+1 >= S the scheme degenerates into
raw replication (tiny N — correct, just not distributed-efficient).

Gravity model matches the existing dist path and its oracle gate:
isolated box (ewald = 0) on wrapped coordinates with per-bucket
min-image unwrap (ops/tree.py:unwrap_to_buckets).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.tree import (TreeSpec, _compact, _safe_invr, build_tree,
                        group_chunk_for, plan_buckets_kd, tree_gravity,
                        unwrap_to_buckets)

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class LetPlan:
    """Host-side LET plan (rebuilt every ntreebuildstep with the
    decomposition)."""

    n_shards: int
    ring_radius: int          # R: raw-exchange ring distance
    spec_comb: TreeSpec       # walk tree over the (2R+1) raw slabs
    g_loc: int                # buckets per shard (padded, pow2)
    pub_depth: int            # published summary depth (== local depth)
    remote_frontier: int      # Wr: frontier cap for far-shard walks
    gmap: np.ndarray          # (S*G_loc, L) LOCAL-slot ids, -1 = pad


def grow_let_caps(plan: LetPlan, factor: float = 1.6) -> LetPlan:
    """Cap growth after a runtime overflow/MAC-failure flag.  Also grows
    the ring radius (a far-shard MAC failure means R was too small)."""
    S = plan.n_shards
    R = plan.ring_radius
    if 2 * (R + 1) + 1 <= S:
        R = R + 1
    return dataclasses.replace(
        plan, ring_radius=R,
        remote_frontier=min(int(plan.remote_frontier * factor) + 8,
                            2 * plan.g_loc),
        spec_comb=dataclasses.replace(
            plan.spec_comb,
            near_cap=min(int(plan.spec_comb.near_cap * factor) + 8,
                         plan.spec_comb.n_leaves),
            frontier=min(int(plan.spec_comb.frontier * factor) + 16,
                         2 * plan.spec_comb.n_leaves),
            support_cap=min(int(plan.spec_comb.support_cap * factor) + 8,
                            plan.spec_comb.n_leaves)))


def plan_let(r_sharded: np.ndarray, perm: np.ndarray, n_shards: int,
             cap: int, z_lo: float, z_extent: float,
             leaf_size: int = 32, theta_sqd: float = 0.1,
             quadrupole: bool = True, h_support: float = 0.0,
             near_cap: int = None,
             prev: Optional[LetPlan] = None,
             w_slab_min: float = None) -> Optional[LetPlan]:
    """Plan the ring-LET decomposition.  Returns None only for S < 2.

    r_sharded: (S*cap, ndim) positions in the padded shard-major layout.
    perm:      (S*cap,) global ids, -1 = padding (from DistPlan).
    z_lo, z_extent: domain z range (slab s = [z_lo + s*w, z_lo + (s+1)*w)).
    h_support: kernrange * h_max — the raw ring must cover kernel support.
    """
    S = n_shards
    if S < 2:
        return None
    ndim = r_sharded.shape[1]
    theta = float(np.sqrt(theta_sqd))
    # work-balanced decompositions have variable slab widths: the ring
    # radius must cover the NARROWEST slab (a far shard at ring distance
    # R+1 is >= R * w_min away from any local target)
    w_slab = w_slab_min if w_slab_min is not None else z_extent / S

    # per-shard KD buckets over the REAL local slots
    gmaps = []
    for s in range(S):
        sl = slice(s * cap, (s + 1) * cap)
        real = np.nonzero(perm[sl] >= 0)[0]
        if len(real) == 0:
            g = np.full((1, leaf_size), -1, np.int32)
        else:
            g_r = plan_buckets_kd(
                np.asarray(r_sharded[sl], np.float64)[real], leaf_size)
            g = np.where(g_r >= 0, real[np.maximum(g_r, 0)],
                         -1).astype(np.int32)
        gmaps.append(g)
    G_loc = max(g.shape[0] for g in gmaps)
    G_loc = 1 << int(np.ceil(np.log2(max(G_loc, 2))))
    gmap = np.full((S, G_loc, leaf_size), -1, np.int32)
    for s, g in enumerate(gmaps):
        gmap[s, :g.shape[0]] = g

    # max leaf-bucket half-diagonal from planned positions
    big = 1e30
    rmax_leaf = 0.0
    for s in range(S):
        ok = gmap[s] >= 0
        if not ok.any():
            continue
        pts = r_sharded[s * cap + np.maximum(gmap[s], 0)]
        lo = np.where(ok[..., None], pts, big).min(axis=1)
        hi = np.where(ok[..., None], pts, -big).max(axis=1)
        occ = ok.any(axis=1)
        half = np.where(occ[..., None], 0.5 * (hi - lo), 0.0)
        rmax_leaf = max(rmax_leaf, float(np.sqrt((half ** 2).sum(-1))
                                         .max()))

    # ring radius: smallest R with theta * (R*w) > slack * rmax_leaf
    # (a far shard at ring distance R+1 is >= R*w from any local target)
    # and R*w covering kernel support for the smoothed near-field.
    slack = 1.2
    need = max(slack * rmax_leaf / theta, slack * h_support)
    R = max(1, int(np.ceil(need / max(w_slab, 1e-30))))
    R = min(R, (S - 1) // 2 + ((S - 1) % 2))   # cap: ring covers all
    while 2 * R + 1 > S and R > 1 and 2 * (R - 1) + 1 >= S:
        R -= 1
    R = min(R, S // 2)  # offsets beyond S//2 wrap onto the other side
    R = max(R, 1)

    depth = int(np.log2(G_loc))
    n_blocks = 2 * R + 1 if 2 * R + 1 < S else S
    G_comb = 1 << int(np.ceil(np.log2(n_blocks * G_loc)))
    if near_cap is None:
        near_cap = int(13.0 * leaf_size
                       * (0.1 / max(theta_sqd, 1e-3)) ** 1.5) + 48
        near_cap = min(near_cap, G_comb)
    spec_comb = TreeSpec(
        n_pad=G_comb * leaf_size, leaf_size=leaf_size,
        depth=int(np.log2(G_comb)),
        frontier=min(max(2 * near_cap, 64), 2 * G_comb),
        theta_sqd=theta_sqd, quadrupole=quadrupole, fast=False,
        near_cap=near_cap,
        group_chunk=group_chunk_for(leaf_size, near_cap),
        support_cap=min(64, G_comb))
    plan = LetPlan(
        n_shards=S, ring_radius=R, spec_comb=spec_comb, g_loc=G_loc,
        pub_depth=depth,
        remote_frontier=min(max(32, G_loc // 8), G_loc),
        gmap=gmap.reshape(S * G_loc, leaf_size))
    if prev is not None and prev.g_loc == G_loc:
        # keep grown caps across replans (monotone, like the grid path)
        plan = dataclasses.replace(
            plan,
            ring_radius=max(R, min(prev.ring_radius, S // 2)),
            remote_frontier=max(plan.remote_frontier,
                                min(prev.remote_frontier, 2 * G_loc)),
            spec_comb=dataclasses.replace(
                plan.spec_comb,
                near_cap=max(plan.spec_comb.near_cap,
                             min(prev.spec_comb.near_cap, G_comb)),
                frontier=max(plan.spec_comb.frontier,
                             min(prev.spec_comb.frontier, 2 * G_comb))))
    return plan


def _pack_levels(tree, tri):
    """Concatenate all tree levels into one (2^(D+1)-1, C) cell table:
    level ell occupies rows [2^ell - 1, 2^(ell+1) - 1)."""
    tabs = []
    for ell in range(len(tree.m)):
        cols = [tree.m[ell][:, None], tree.com[ell], tree.half[ell]]
        if tri is not None:
            q = tree.quad[ell]
            cols.append(jnp.stack([q[:, i, j] for i, j in tri], -1))
        tabs.append(jnp.concatenate(cols, -1))
    return jnp.concatenate(tabs, axis=0)


def _mp_eval(dr, m, q6, tri, ndim):
    """Per-target multipole acceleration/potential (upper-tri quad)."""
    drsqd = jnp.sum(dr * dr, axis=-1)
    inv_r = _safe_invr(drsqd)
    inv_r3 = inv_r * inv_r * inv_r
    a = m[..., None] * dr * inv_r3[..., None]
    pot = m * inv_r
    if q6 is not None:
        inv_r5 = inv_r3 * inv_r * inv_r
        qdr = []
        for i in range(ndim):
            acc = 0.0
            for j in range(ndim):
                x, y = (i, j) if i <= j else (j, i)
                acc = acc + q6[..., tri.index((x, y))] * dr[..., j]
            qdr.append(acc)
        qdr = jnp.stack(qdr, -1)
        drqdr = jnp.sum(qdr * dr, axis=-1)
        a = a - inv_r5[..., None] * qdr \
            + 2.5 * (drqdr * inv_r5 * inv_r * inv_r)[..., None] * dr
        pot = pot + 0.5 * drqdr * inv_r5
    return a, pot


def let_gravity(plan: LetPlan, gmap_loc: Array, r: Array, m: Array,
                h: Array, zh: Array, alive: Array, kern,
                periodic_extent=None, ewald_table=None,
                axis_name: str = "dp"):
    """Distributed ring-LET gravity for this shard's particles.

    Runs INSIDE shard_map.  r/m/h/zh/alive are the (cap, ...) local
    blocks; gmap_loc is this shard's (G_loc, L) bucket gather map of
    LOCAL slot ids.  Returns (a, gpot, overflow) in local slot order —
    nothing O(N_total) is ever materialised.

    With `ewald_table` the walk runs in true-periodic mode: the combined
    (ring) tree walk min-images + Ewald-corrects every MAC/cell/pair
    interaction (ops/tree.py handles this), and the far-shard summary
    walk below min-images its MAC geometry and adds the monopole-level
    Ewald correction for accepted cells — the same treatment the
    replicated walk gives accepted cells (reference Ewald.cpp:500 called
    from the cell loop, GradhSphTree.cpp:900-1020).
    """
    spec = plan.spec_comb
    S = plan.n_shards
    R = plan.ring_radius
    L = spec.leaf_size
    G_loc = plan.g_loc
    n_blocks = 2 * R + 1 if 2 * R + 1 < S else S
    ndim = r.shape[1]
    dtype = r.dtype
    tri = [(i, j) for i in range(ndim) for j in range(i, ndim)] \
        if spec.quadrupole else None
    nq = len(tri) if tri else 0
    idx_shard = lax.axis_index(axis_name)

    # ---- local bucket-sorted block (static gather map) -------------------
    flat = gmap_loc.reshape(-1)
    safe = jnp.maximum(flat, 0)
    in_map = flat >= 0
    loc_spec = dataclasses.replace(spec, n_pad=G_loc * L,
                                   depth=int(np.log2(G_loc)))
    r_l = jnp.where(in_map[:, None], r[safe], 1e15)
    if periodic_extent is not None:
        r_l = unwrap_to_buckets(loc_spec, r_l, in_map, periodic_extent)
    m_l = jnp.where(in_map & alive[safe], m[safe], 0.0)
    h_l = jnp.where(in_map, h[safe], 1.0)
    zh_l = jnp.where(in_map, zh[safe], 0.0)
    alive_l = in_map & alive[safe]
    # one packed (G_loc*L, ndim+4) payload so each ring hop is ONE
    # ppermute (alive folded into m > 0)
    pay = jnp.concatenate(
        [r_l, m_l[:, None], h_l[:, None], zh_l[:, None],
         alive_l[:, None].astype(dtype)], -1)

    # ---- published pruned summary of the LOCAL tree ----------------------
    tree_loc = build_tree(loc_spec, r_l, m_l, alive_l)
    pub = _pack_levels(tree_loc, tri)            # (2^(d+1)-1, C)
    if n_blocks < S:
        pub_all = lax.all_gather(pub, axis_name)  # (S, ncells, C)

    # ---- raw ring exchange ----------------------------------------------
    blocks = {0: pay}
    for dist_hop in range(1, (n_blocks - 1) // 2 + 1):
        up = [(i, (i + dist_hop) % S) for i in range(S)]
        down = [(i, (i - dist_hop) % S) for i in range(S)]
        blocks[-dist_hop] = lax.ppermute(pay, axis_name, up)
        blocks[+dist_hop] = lax.ppermute(pay, axis_name, down)
    if n_blocks % 2 == 0:
        # even block count (n_blocks == S): one extra one-sided block
        hop = n_blocks // 2
        up = [(i, (i + hop) % S) for i in range(S)]
        blocks[-hop] = lax.ppermute(pay, axis_name, up)
    offs = sorted(blocks)
    comb = jnp.concatenate([blocks[o] for o in offs], axis=0)
    local_block = offs.index(0)
    pad_rows = spec.n_pad - comb.shape[0]
    if pad_rows:
        padrow = jnp.zeros((pad_rows, comb.shape[1]), dtype)
        padrow = padrow.at[:, :ndim].set(1e15)
        padrow = padrow.at[:, ndim + 1].set(1.0)
        comb = jnp.concatenate([comb, padrow], axis=0)
    r_c = comb[:, :ndim]
    m_c = comb[:, ndim]
    h_c = comb[:, ndim + 1]
    zh_c = comb[:, ndim + 2]
    alive_c = comb[:, ndim + 3] > 0.5

    # ---- combined tree + walk for the LOCAL groups only ------------------
    tree_c = build_tree(spec, r_c, m_c, alive_c)
    res, overflow = tree_gravity(
        spec, tree_c, r_c, m_c, alive_c, h_c, kern, zh_c,
        group_range=(local_block * G_loc, G_loc),
        ewald_table=ewald_table,
        ewald_extent=periodic_extent if ewald_table is not None else None)
    a_sorted = res.a                              # (G_loc*L, ndim)
    pot_sorted = res.gpot

    # ---- far shards: MAC-checked walk of published summaries -------------
    if n_blocks < S:
        theta_sqd = spec.theta_sqd
        p_d = plan.pub_depth
        Wr = plan.remote_frontier
        leaf_centre = tree_loc.centre[-1]
        leaf_half = tree_loc.half[-1]
        r_leaf = r_l.reshape(G_loc, L, ndim)
        far_offs = [o for o in range(-(S - 1) // 2, S - (S - 1) // 2)
                    if o not in offs]
        # enumerate each remaining shard exactly once via positive offsets
        far_ts = sorted({(o) % S for o in far_offs} - {0})

        def far_group(g):
            rt = r_leaf[g]
            gc = leaf_centre[g]
            gh = leaf_half[g]
            a_acc = jnp.zeros((L, ndim), dtype)
            pot_acc = jnp.zeros((L,), dtype)
            flag = jnp.asarray(False)
            for off in far_ts:
                t = (idx_shard + off) % S
                tab_t = lax.dynamic_index_in_dim(pub_all, t, axis=0,
                                                 keepdims=False)
                front = jnp.zeros((1,), jnp.int32)
                for ell in range(p_d + 1):
                    off0 = (1 << ell) - 1
                    valid = front >= 0
                    idxc = jnp.maximum(front, 0)
                    tab = tab_t[off0 + idxc]
                    mm = jnp.where(valid, tab[:, 0], 0.0)
                    com = tab[:, 1:1 + ndim]
                    half = tab[:, 1 + ndim:1 + 2 * ndim]
                    q6 = tab[:, 1 + 2 * ndim:] if nq else None
                    dcc = com - gc
                    if ewald_table is not None:
                        # periodic walk geometry: a cell CLOSE through
                        # the seam must be opened (ops/tree.py:386-391)
                        from ..ops.tree import _ext_safe
                        _Lg = _ext_safe(periodic_extent, dtype)
                        dcc = dcc - _Lg * jnp.round(dcc / _Lg)
                    gap = jnp.maximum(jnp.abs(dcc) - gh, 0.0)
                    dsqd = jnp.sum(gap * gap, axis=-1)
                    rmax_sqd = jnp.sum(half * half, axis=-1)
                    occn = mm > 0.0
                    passed = dsqd * theta_sqd > rmax_sqd
                    if ell < p_d:
                        accept = occn & passed
                        open_ = occn & ~accept
                    else:
                        accept = occn
                        flag = flag | jnp.any(occn & ~passed)
                        open_ = jnp.zeros_like(accept)
                    m_a = jnp.where(accept, mm, 0.0)
                    dr = com[None, :, :] - rt[:, None, :]
                    if ewald_table is not None:
                        from ..ops.tree import _ext_safe
                        _L = _ext_safe(periodic_extent, dtype)
                        dr = dr - _L * jnp.round(dr / _L)
                    a_f, p_f = _mp_eval(
                        dr, m_a[None, :],
                        q6[None] if q6 is not None else None, tri, ndim)
                    if ewald_table is not None:
                        from ..ops.ewald import ewald_correction

                        e_a, e_p = ewald_correction(ewald_table, dr)
                        a_f = a_f + m_a[None, :, None] * e_a
                        p_f = p_f + m_a[None, :] * e_p
                    a_acc = a_acc + jnp.sum(a_f, axis=1)
                    pot_acc = pot_acc + jnp.sum(p_f, axis=1)
                    if ell < p_d:
                        kids = jnp.stack(
                            [jnp.where(open_, 2 * idxc, -1),
                             jnp.where(open_, 2 * idxc + 1, -1)],
                            -1).reshape(-1)
                        W_next = min(Wr, 1 << (ell + 1))
                        if kids.shape[0] <= W_next:
                            front = kids
                        else:
                            front, n_f = _compact(
                                kids >= 0, kids, W_next,
                                jnp.asarray(-1, jnp.int32))
                            flag = flag | (n_f > W_next)
            return a_acc, pot_acc, flag

        group_chunk = min(spec.group_chunk, G_loc)
        n_chunks = -(-G_loc // group_chunk)
        gids = jnp.arange(n_chunks * group_chunk, dtype=jnp.int32) % G_loc
        a_r, pot_r, flags = lax.map(jax.vmap(far_group),
                                    gids.reshape(n_chunks, group_chunk))
        a_sorted = a_sorted + a_r.reshape(-1, L, ndim)[:G_loc] \
            .reshape(-1, ndim)
        pot_sorted = pot_sorted + pot_r.reshape(-1, L)[:G_loc].reshape(-1)
        overflow = overflow | jnp.any(flags)

    # ---- scatter back to local slot order --------------------------------
    a_out = jnp.zeros((r.shape[0], ndim), dtype).at[safe].add(
        jnp.where(in_map[:, None], a_sorted, 0.0))
    pot_out = jnp.zeros((r.shape[0],), dtype).at[safe].add(
        jnp.where(in_map, pot_sorted, 0.0))
    overflow = lax.pmax(overflow.astype(jnp.int32), axis_name) > 0
    return a_out, pot_out, overflow
