"""TreeRay-style reverse ray-traced radiation transport, in dense ray-marching form.

Re-design of the reference's TreeRay module (src/Radiation/TreeRay.cpp:
1-1003 + TreeRayOnTheSpot.cpp, HEALPix directions via chealpix.c): the
reference maps tree nodes onto per-target HEALPix rays and integrates
column densities adaptively along each ray — a pointer-chasing walk per
(target, ray).

Dense formulation: radiation quantities are integrated by FIXED-STEP
ray marching through the structured density grid (ops/sph_grid27) —
every (target, direction, step) sample is one gather from a dense
per-cell field, so the whole transport pass is a single vectorised
gather/reduce with static shapes:

- `healpix_directions(nside)`: exact HEALPix RING-scheme pixel centres
  (12 nside^2 equal-area directions; Gorski et al. 2005 — the same
  direction set chealpix's pix2vec_ring produces).
- `cell_field`: volume-averaged per-cell fields from the binned
  particles (n_H^2 for recombination integrals, rho for columns).
- `column_density_map`: per-particle column density along each HEALPix
  direction out to the domain edge (the TreeRay ambient-field integral).
- `treeray_ionisation`: OnTheSpot ionisation with SHADOWING — each
  particle ray-marches TOWARD each source accumulating the
  recombination integral int n_H^2 alphaB dl; the particle is ionised
  when the source's flux survives the path:
      Ndot / (4 pi d^2) >= alphaB * int n_H^2 dl
  Dense clumps between source and target absorb the photons and cast
  shadows — the behaviour the spherically-averaged balance
  (ops/ionisation.py) cannot produce.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

Array = jnp.ndarray


# ---------------------------------------------------------------------------
# HEALPix RING-scheme pixel centres (chealpix pix2ang_ring equivalent)
# ---------------------------------------------------------------------------

def healpix_directions(nside: int) -> np.ndarray:
    """(12 nside^2, 3) unit vectors of HEALPix RING pixel centres
    (Gorski et al. 2005, eqs. 2-6; the direction table the reference
    obtains from chealpix.c pix2vec_ring).

    North polar cap: rings i = 1..nside-1 with 4i pixels,
        z = 1 - i^2/(3 nside^2),  phi = (pi/2i)(j + 1/2).
    Equatorial belt: rings i = nside..3*nside with 4 nside pixels,
        z = 4/3 - 2i/(3 nside),   phi = (pi/2ns)(j + s/2),
        s = (i - nside + 1) mod 2.
    South cap mirrors the north."""
    n = nside
    npix = 12 * n * n
    ncap = 2 * n * (n - 1)
    z = np.empty(npix)
    phi = np.empty(npix)

    def cap_ring(p):
        """Ring index i >= 1 such that 2 i (i-1) <= p < 2 (i+1) i."""
        i = ((1.0 + np.sqrt(1.0 + 2.0 * p)) / 2.0).astype(np.int64)
        i = np.maximum(i, 1)
        over = 2 * i * (i - 1) > p
        while over.any():
            i = i - over.astype(np.int64)
            over = 2 * i * (i - 1) > p
        under = 2 * (i + 1) * i <= p
        while under.any():
            i = i + under.astype(np.int64)
            under = 2 * (i + 1) * i <= p
        return i

    if ncap > 0:
        p = np.arange(ncap)
        i = cap_ring(p)
        j = p - 2 * i * (i - 1)
        z[:ncap] = 1.0 - (i * i) / (3.0 * n * n)
        phi[:ncap] = (np.pi / (2.0 * i)) * (j + 0.5)
        # south cap: mirror with reversed in-ring order
        q = npix - 1 - np.arange(npix - ncap, npix)
        i_s = cap_ring(q)
        j_s = q - 2 * i_s * (i_s - 1)
        z[npix - ncap:] = -(1.0 - (i_s * i_s) / (3.0 * n * n))
        phi[npix - ncap:] = (np.pi / (2.0 * i_s)) * (4 * i_s - j_s - 0.5)

    belt = np.arange(ncap, npix - ncap) - ncap
    i_b = belt // (4 * n) + n
    j_b = belt % (4 * n)
    z[ncap:npix - ncap] = 4.0 / 3.0 - (2.0 * i_b) / (3.0 * n)
    s = (i_b - n + 1) % 2
    phi[ncap:npix - ncap] = (np.pi / (2.0 * n)) * (j_b + 0.5 * s)

    st = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([st * np.cos(phi), st * np.sin(phi), z], axis=-1)


# ---------------------------------------------------------------------------
# per-cell fields + ray marching
# ---------------------------------------------------------------------------

def cell_field(spec, b, m: Array, rho: Array, mu_bar: float = 1.0):
    """Volume-averaged per-cell (rho, n_H^2) from the binned particles:
    <f> = sum_slots f_p (m_p / rho_p) / V_cell (the particle's volume
    element weights it)."""
    from . import sph_grid27 as g

    vol_cell = 1.0
    for k in range(spec.ndim):
        vol_cell *= spec.extents[k] / spec.ncells[k]
    w = m / jnp.maximum(rho, 1e-30)                  # particle volume
    dense_w = g.to_dense(spec, b, w)
    fill = g.dense_fill_mask(spec, b)
    dense_w = jnp.where(fill, dense_w, 0.0)
    rho_d = jnp.where(fill, g.to_dense(spec, b, rho), 0.0)
    rho_cell = jnp.sum(dense_w * rho_d, axis=-1) / vol_cell
    nh2_cell = jnp.sum(dense_w * (rho_d / mu_bar) ** 2, axis=-1) / vol_cell
    return rho_cell, nh2_cell


def _march(spec, field: Array, r0: Array, dirs: Array, lengths: Array,
           n_steps: int) -> Array:
    """Integrate `field` (per-cell, shape *ncells) along straight rays:
    r(t) = r0 + t*dir for t in (0, length), midpoint rule with n_steps
    fixed samples.  r0: (N, 3); dirs: (N, D, 3) or (D, 3); lengths like
    dirs' leading dims.  Returns (N, D) integrals."""
    nd = spec.ndim
    lo = jnp.asarray(spec.lo)
    inv_cell = jnp.asarray([spec.ncells[k] / spec.extents[k]
                            for k in range(nd)])
    ncells = spec.ncells
    if dirs.ndim == 2:
        dirs = jnp.broadcast_to(dirs[None], (r0.shape[0],) + dirs.shape)
        lengths = jnp.broadcast_to(lengths[None],
                                   (r0.shape[0],) + lengths.shape)
    ts = (jnp.arange(n_steps) + 0.5) / n_steps       # (S,)
    # sample positions: (N, D, S, nd)
    pos = r0[:, None, None, :] + (lengths[..., None, None]
                                  * ts[None, None, :, None]
                                  * dirs[:, :, None, :])
    # periodic dims wrap the samples back into the box; open dims mask
    # out-of-domain samples to zero
    ext = jnp.asarray(spec.extents)
    for k in range(nd):
        if spec.periodic[k]:
            pos = pos.at[..., k].set(
                lo[k] + jnp.mod(pos[..., k] - lo[k], ext[k]))
    ix = jnp.floor((pos - lo) * inv_cell).astype(jnp.int32)
    inside = jnp.all((ix >= 0) & (ix < jnp.asarray(ncells)), axis=-1)
    ix = jnp.clip(ix, 0, jnp.asarray(ncells) - 1)
    flat = jnp.zeros(ix.shape[:-1], jnp.int32)
    for k in range(nd):
        flat = flat * ncells[k] + ix[..., k]
    samp = jnp.where(inside, field.reshape(-1)[flat], 0.0)
    return jnp.sum(samp, axis=-1) * lengths / n_steps


def column_density_map(spec, rho_cell: Array, r: Array,
                       dirs: np.ndarray, n_steps: int = 32) -> Array:
    """(N, D) column densities int rho dl from each particle to the
    domain edge along each direction (the TreeRay ambient integral)."""
    # length to the domain bounding box along each direction
    lo = jnp.asarray(spec.lo)
    hi = lo + jnp.asarray(spec.extents)
    d = jnp.asarray(dirs)
    eps = 1e-30
    t_hi = (hi[None, None, :] - r[:, None, :]) / jnp.where(
        jnp.abs(d) > eps, d, eps)[None, :, :]
    t_lo = (lo[None, None, :] - r[:, None, :]) / jnp.where(
        jnp.abs(d) > eps, d, eps)[None, :, :]
    t_exit = jnp.min(jnp.maximum(t_hi, t_lo), axis=-1)   # (N, D)
    t_exit = jnp.maximum(t_exit, 0.0)
    dirs_b = jnp.broadcast_to(d[None], (r.shape[0],) + d.shape)
    return _march(spec, rho_cell, r, dirs_b, t_exit, n_steps)


def treeray_ionisation(spec, nh2_cell: Array, r: Array,
                       r_src: Array, ndot_src: Array, active_src: Array,
                       alphaB: float, n_steps: int = 48) -> Array:
    """OnTheSpot ionisation with shadowing (TreeRayOnTheSpot):

    particle i is ionised by source s when the photon flux at i exceeds
    the recombinations along the path:
        ndot_s / (4 pi d_is^2)  >=  alphaB * int_0^d n_H^2 dl .
    Returns the (N,) ionised mask (any source)."""
    # rays from each particle TOWARD each source (min-imaged on
    # periodic dims so the ray takes the short way round)
    dr = r_src[None, :, :] - r[:, None, :]           # (N, S, 3)
    ext = jnp.asarray(spec.extents)
    for k in range(spec.ndim):
        if spec.periodic[k]:
            dr = dr.at[..., k].add(
                -ext[k] * jnp.round(dr[..., k] / ext[k]))
    d = jnp.sqrt(jnp.sum(dr * dr, axis=-1))
    dirs = dr / jnp.maximum(d, 1e-30)[..., None]
    integral = _march(spec, nh2_cell, r, dirs, d, n_steps)   # (N, S)
    flux = ndot_src[None, :] / (4.0 * jnp.pi
                                * jnp.maximum(d, 1e-30) ** 2)
    ion = (flux >= alphaB * integral) & active_src[None, :] \
        & (ndot_src[None, :] > 0.0)
    return jnp.any(ion, axis=-1)
