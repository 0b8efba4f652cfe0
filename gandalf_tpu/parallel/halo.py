"""Multi-device halo exchange for the structured-grid SPH pipeline.

SPMD analogue of the reference's MPI domain decomposition + ghost
particle exchange (SURVEY.md §2.6; reference src/MpiControl,
GhostNeighbours.hpp): the dense (nz, ny, nx, K, ...) cell tensors are
sharded along the leading (z) axis over a 1-D `jax.sharding.Mesh`, and
each device exchanges ONE layer of boundary cells with its ring
neighbours via `lax.ppermute` — the collective rides the ICI mesh, not
host memory.  y/x ghost layers stay device-local.

The physics inside each shard is the unmodified 27-shift pipeline
(ops/sph_grid27.py) with the z-ghosting swapped for the ppermute halos,
so single-device and sharded results agree to reduction-order roundoff.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import sph_grid27 as g

Array = jnp.ndarray


def make_halo_ghost_fn(axis_name: str, global_spec, local_spec):
    """Returns a ghost_fn for density_grid27/forces_grid27 that supplies
    the dim-0 ghost layers from the ring neighbours (lax.ppermute) and
    ghosts the remaining dims locally.

    qz rows are exchanged per face.  When a slab is NARROWER than qz rows
    (clustered distributions: z cells below the kernel support, one row
    per shard), the halo spans several ring neighbours — each extra hop
    ppermutes the whole slab one position further and contributes its
    rows (the analogue of the reference's multi-rank ghost walks,
    src/Hydrodynamics/Ghosts.cpp:161-202)."""
    nd = global_spec.ndim
    qz = global_spec.qz
    nz_loc = local_spec.ncells[0]
    n_hops = -(-qz // nz_loc)            # ceil

    def ghost(spec_local, x, shift_vec=None):
        ndev = lax.axis_size(axis_name)
        idx = lax.axis_index(axis_name)
        up = [(i, (i + 1) % ndev) for i in range(ndev)]
        down = [(i, (i - 1) % ndev) for i in range(ndev)]
        L = global_spec.extents[0]

        def fix(block, src_idx):
            """Apply seam wrap shift / open-edge zeroing for a block whose
            source device index (unwrapped) is src_idx."""
            wrapped_lo = src_idx < 0
            wrapped_hi = src_idx > ndev - 1
            if global_spec.periodic[0]:
                if shift_vec is not None:
                    block = jnp.where(wrapped_lo,
                                      block.at[..., 0].add(-L), block)
                    block = jnp.where(wrapped_hi,
                                      block.at[..., 0].add(L), block)
                return block
            return jnp.where(wrapped_lo | wrapped_hi,
                             jnp.zeros_like(block), block)

        # hop k moves slabs k positions around the ring; collect enough
        # rows below/above, then trim to exactly qz
        lo_blocks, hi_blocks = [], []
        cur_lo = cur_hi = x
        for k in range(1, n_hops + 1):
            cur_lo = lax.ppermute(cur_lo, axis_name, up)
            cur_hi = lax.ppermute(cur_hi, axis_name, down)
            lo_blocks.insert(0, fix(cur_lo, idx - k))
            hi_blocks.append(fix(cur_hi, idx + k))
        lo_halo = jnp.concatenate(lo_blocks, axis=0) if n_hops > 1 \
            else lo_blocks[0]
        hi_halo = jnp.concatenate(hi_blocks, axis=0) if n_hops > 1 \
            else hi_blocks[0]
        lo_halo = lax.slice_in_dim(lo_halo, lo_halo.shape[0] - qz,
                                   lo_halo.shape[0], axis=0)
        hi_halo = lax.slice_in_dim(hi_halo, 0, qz, axis=0)
        out = jnp.concatenate([lo_halo, x, hi_halo], axis=0)
        return g.add_ghost_layers(spec_local, out, shift_vec=shift_vec,
                                  dims=range(1, nd))

    return ghost


def make_halo_ghost_fn_balanced(axis_name: str, global_spec, local_spec,
                                row_len):
    """ghost_fn for the WORK-BALANCED decomposition (variable contiguous
    row ranges padded to a common tensor shape; DistPlan.balanced).

    Shard s's local tensor has nz_pad rows of which the first
    row_len[s] are real.  The halo exchange is single-hop:

    - low side: each shard dynamic-slices its LAST qz real rows
      (rows [len-qz, len)) and ppermutes them up the ring;
    - high side: each shard ppermutes its first B rows down the ring,
      where B = nz_pad - min(row_len) + qz is a STATIC bound on how many
      rows any receiver needs; the receiver dynamic-update-slices the
      block at row len (its pad rows double as the receive window, so
      the 27-shift stencil sees the next shard's cells as ordinary +z
      neighbours).

    Requires min(row_len) >= qz (checked at plan time; the planner falls
    back to the uniform split otherwise).

    This is the analogue of the reference's work-balanced MPI
    ghost exchange (FindLoadBalancingDivision split +
    Ghosts::CopyHydroDataToGhosts over variable domain widths,
    src/Tree/HydroTree.cpp:1554, src/Hydrodynamics/Ghosts.cpp:161-202)."""
    nd = global_spec.ndim
    qz = global_spec.qz
    nz_pad = local_spec.ncells[0]
    lens_np = np.asarray(row_len, np.int32)
    B = int(nz_pad - lens_np.min() + qz)
    if lens_np.min() < qz:
        raise ValueError("balanced halo needs min(row_len) >= qz")

    def ghost(spec_local, x, shift_vec=None):
        ndev = lax.axis_size(axis_name)
        idx = lax.axis_index(axis_name)
        up = [(i, (i + 1) % ndev) for i in range(ndev)]
        down = [(i, (i - 1) % ndev) for i in range(ndev)]
        L = global_spec.extents[0]
        lens = jnp.asarray(lens_np)
        len_me = lens[idx]

        def fix(block, wrapped):
            """Seam wrap shift / open-edge zeroing (wrapped: bool)."""
            if global_spec.periodic[0]:
                if shift_vec is not None:
                    sgn = jnp.where(wrapped == 1, -L,
                                    jnp.where(wrapped == -1, L, 0.0))
                    block = block.at[..., 0].add(
                        jnp.asarray(sgn, block.dtype))
                return block
            return jnp.where(wrapped != 0, jnp.zeros_like(block), block)

        # low halo: prev shard's last qz real rows
        tail = lax.dynamic_slice_in_dim(x, len_me - qz, qz, axis=0)
        lo_halo = lax.ppermute(tail, axis_name, up)
        lo_halo = fix(lo_halo, jnp.where(idx == 0, 1, 0))
        # high side: next shard's first B rows land at row len_me
        head = lax.slice_in_dim(x, 0, B, axis=0)
        nxt = lax.ppermute(head, axis_name, down)
        nxt = fix(nxt, jnp.where(idx == ndev - 1, -1, 0))
        # canvas long enough that the B-row update NEVER clamps (a clamp
        # would overwrite the longest shard's real rows), then trimmed to
        # the nz_pad + qz rows the stencil actually reads
        canvas = jnp.concatenate(
            [x, jnp.zeros((B,) + x.shape[1:], x.dtype)], axis=0)
        canvas = lax.dynamic_update_slice_in_dim(canvas, nxt, len_me,
                                                 axis=0)
        canvas = lax.slice_in_dim(canvas, 0, nz_pad + qz, axis=0)
        out = jnp.concatenate([lo_halo, canvas], axis=0)
        return g.add_ghost_layers(spec_local, out, shift_vec=shift_vec,
                                  dims=range(1, nd))

    return ghost


def hydro_pass_grid27_sharded(mesh: Mesh, axis_name: str,
                              kern, visc, box, spec, eos,
                              h_fac: float, h_converge: float,
                              hydro_forces: bool, s):
    """Structured-grid hydro pass with the dense cell tensors sharded
    along z over `mesh` and halo layers exchanged over ICI.

    Binning/scatter stay replicated (cheap O(N) vs the O(N K) pair work);
    the density iteration and the 27-shift force pass run shard-local.
    Returns the updated SphState (replicated particle arrays)."""
    nd = s.ndim
    ndev = mesh.shape[axis_name]
    if spec.ncells[0] % ndev != 0:
        raise ValueError(f"ncells[0]={spec.ncells[0]} not divisible by "
                         f"the {ndev}-device mesh")
    local_spec = dataclasses.replace(
        spec, ncells=(spec.ncells[0] // ndev,) + spec.ncells[1:])

    b = g.bin_particles(spec, s.r)
    hmax = g.hmax_of(spec, kern.kernrange)
    d = lambda x: g.to_dense(spec, b, x)
    fill = g.dense_fill_mask(spec, b)
    dense_in = {
        "r": d(s.r), "v": d(s.v), "m": d(s.m), "h": d(s.h),
        "u": d(s.u), "alpha": d(s.alpha), "fill": fill,
    }

    zshard = NamedSharding(mesh, P(axis_name))
    in_specs = {k: P(axis_name) for k in dense_in}
    out_specs = (P(axis_name),) * 9 + (P(),)

    @partial(shard_map, mesh=mesh, in_specs=(in_specs,),
             out_specs=out_specs, check_vma=False)
    def local_pass(dn: Dict[str, Array]):
        ghost = make_halo_ghost_fn(axis_name, spec, local_spec)
        dens = g.density_grid27(kern, local_spec, h_fac, h_converge,
                                dn["r"], dn["m"], dn["h"], dn["fill"],
                                hmax, ghost_fn=ghost)
        u_d, press_d, sound_d = eos.thermal_update(
            jnp.maximum(dens.rho, 1e-30), dn["u"])
        if hydro_forces:
            fields = {"r": dn["r"], "v": dn["v"], "m": dn["m"],
                      "h": dens.h, "rho": dens.rho, "u": u_d,
                      "pressure": press_d, "sound": sound_d,
                      "invomega": dens.invomega, "hfactor": dens.hfactor,
                      "alpha": dn["alpha"]}
            a_d, dudt_d, div_v_d, _ = g.forces_grid27(
                kern, visc, local_spec, fields, dn["fill"],
                ghost_fn=ghost)
        else:
            a_d = jnp.zeros_like(dn["r"])
            dudt_d = jnp.zeros_like(dn["m"])
            div_v_d = jnp.zeros_like(dn["m"])
        overflow = lax.pmax(dens.overflow.astype(jnp.int32),
                            axis_name) > 0
        return (dens.h, dens.rho, dens.invomega, dens.zeta, dens.hfactor,
                u_d, press_d, sound_d,
                jnp.concatenate([a_d, dudt_d[..., None],
                                 div_v_d[..., None]], axis=-1),
                overflow)

    # place the dense tensors on the mesh, run, gather back per particle
    dense_in = {k: jax.device_put(v, zshard) for k, v in dense_in.items()}
    (h_d, rho_d, invom_d, zeta_d, hfac_d, u_d, press_d, sound_d,
     adiv_d, overflow) = local_pass(dense_in)

    p = lambda x: g.from_dense(spec, b, x)
    a = p(adiv_d[..., :nd])
    dudt = p(adiv_d[..., nd])
    div_v = p(adiv_d[..., nd + 1])
    return s.replace(
        h=p(h_d), rho=p(rho_d), invomega=p(invom_d), zeta=p(zeta_d),
        hfactor=p(hfac_d), u=p(u_d), pressure=p(press_d),
        sound=p(sound_d), a=a, dudt=dudt, div_v=div_v,
        neib_overflow=s.neib_overflow | overflow)
