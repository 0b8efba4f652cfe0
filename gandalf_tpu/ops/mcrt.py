"""Monte-Carlo radiation transport on the structured grid, in dense lockstep form.

Re-design of the reference's TreeMonteCarlo / MonochromaticIonisation-
MonteCarlo modules (src/Thermal/TreeMonteCarlo.cpp + src/Tree/
KDRadiationTree.cpp:1-1078, src/Thermal/MonochromaticIonisation-
MonteCarlo.cpp): the reference emits photon packets from sources and
walks them cell-by-cell through the KDRadiationTree, accumulating the
Lucy (1999) path-length estimate of the radiation energy density and
sampling absorption events per cell.

Dense formulation: ALL packets advance in lockstep with a fixed
step through the dense per-cell fields of the radiation grid
(ops/sph_grid27 cells, the KDRadiationTree analogue) — every
(packet, step) is one gather + one scatter-add with static shapes, no
per-packet control flow:

- packets carry continuous weights attenuated by exp(-kappa rho ds)
  each step (continuous absorption — the zero-variance version of the
  reference's sampled absorption events);
- the Lucy estimator accumulates w * ds per visited cell:
      u_rad = (L / Nphoton) * sum(w ds) / (c V_cell),
- the absorbed weight per cell gives the photoionisation rate for the
  monochromatic ionisation balance, iterated to convergence exactly
  like the reference's radiation<->ionisation loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray


def _cell_volume(spec) -> float:
    v = 1.0
    for k in range(spec.ndim):
        v *= spec.extents[k] / spec.ncells[k]
    return v


def _flat_cell_index(spec, pos):
    """(..., nd) positions -> (flat cell index, inside-domain mask);
    periodic dims wrap, open dims mask."""
    nd = spec.ndim
    lo = jnp.asarray(spec.lo)
    ext = jnp.asarray(spec.extents)
    inv_cell = jnp.asarray([spec.ncells[k] / spec.extents[k]
                            for k in range(nd)])
    for k in range(nd):
        if spec.periodic[k]:
            pos = pos.at[..., k].set(
                lo[k] + jnp.mod(pos[..., k] - lo[k], ext[k]))
    ix = jnp.floor((pos - lo) * inv_cell).astype(jnp.int32)
    inside = jnp.all((ix >= 0) & (ix < jnp.asarray(spec.ncells)),
                     axis=-1)
    ix = jnp.clip(ix, 0, jnp.asarray(spec.ncells) - 1)
    flat = jnp.zeros(ix.shape[:-1], jnp.int32)
    for k in range(nd):
        flat = flat * spec.ncells[k] + ix[..., k]
    return flat, inside


def isotropic_directions(key, n: int, ndim: int = 3) -> Array:
    """n uniformly random unit vectors (the reference draws packet
    directions from its RNG the same way, TreeMonteCarlo.cpp emission)."""
    if ndim == 3:
        k1, k2 = jax.random.split(key)
        mu = jax.random.uniform(k1, (n,), minval=-1.0, maxval=1.0)
        phi = jax.random.uniform(k2, (n,), minval=0.0,
                                 maxval=2.0 * np.pi)
        s = jnp.sqrt(jnp.maximum(1.0 - mu * mu, 0.0))
        return jnp.stack([s * jnp.cos(phi), s * jnp.sin(phi), mu], -1)
    if ndim == 2:
        phi = jax.random.uniform(key, (n,), minval=0.0,
                                 maxval=2.0 * np.pi)
        return jnp.stack([jnp.cos(phi), jnp.sin(phi)], -1)
    sgn = jax.random.bernoulli(key, 0.5, (n,))
    return jnp.where(sgn, 1.0, -1.0)[:, None]


def propagate_packets(spec, opacity_cell: Array, r0: Array, dirs: Array,
                      n_steps: int, step_frac: float = 0.5):
    """March n packets in lockstep through the grid.

    opacity_cell: per-cell absorption coefficient kappa*rho (1/length),
    shape *ncells.  r0 (Np, nd) starts; dirs (Np, nd) unit directions.
    Step length = step_frac * min cell edge.  Returns
    (pathlen_cell, absorbed_cell, escaped_weight): sum of w*ds per cell
    (Lucy estimator numerator), absorbed weight per cell, and the total
    weight that left the domain (flat *ncells grids)."""
    nd = spec.ndim
    ds = step_frac * min(spec.extents[k] / spec.ncells[k]
                         for k in range(nd))
    n_cells = 1
    for k in range(nd):
        n_cells *= spec.ncells[k]
    op_flat = opacity_cell.reshape(-1)

    def body(carry, _):
        pos, w = carry
        mid = pos + (0.5 * ds) * dirs
        flat, inside = _flat_cell_index(spec, mid)
        tau = jnp.where(inside, op_flat[flat] * ds, 0.0)
        absorb = w * (1.0 - jnp.exp(-tau))
        # Lucy path-length estimate uses the mean weight over the step
        # (exact integral of w(l) dl for exponential attenuation)
        wpath = jnp.where(tau > 1e-12, absorb / jnp.maximum(op_flat[flat],
                                                            1e-300),
                          w * ds)
        path_c = jnp.zeros((n_cells,), w.dtype).at[flat].add(
            jnp.where(inside, wpath, 0.0))
        abs_c = jnp.zeros((n_cells,), w.dtype).at[flat].add(
            jnp.where(inside, absorb, 0.0))
        esc = jnp.sum(jnp.where(inside, 0.0, w))
        w_new = jnp.where(inside, w - absorb, 0.0)
        return (pos + ds * dirs, w_new), (path_c, abs_c, esc)

    (_, w_end), (paths, absorbs, escs) = jax.lax.scan(
        body, (r0, jnp.ones((r0.shape[0],), r0.dtype)),
        None, length=n_steps)
    pathlen = jnp.sum(paths, 0).reshape(spec.ncells)
    absorbed = jnp.sum(absorbs, 0).reshape(spec.ncells)
    escaped = jnp.sum(escs) + jnp.sum(w_end)
    return pathlen, absorbed, escaped


def mc_radiation_field(spec, opacity_cell: Array, r_src: Array,
                       L_src: Array, key, n_packets: int,
                       n_steps: int = 256, c_light: float = 1.0,
                       step_frac: float = 0.5):
    """Lucy (1999) radiation energy density from point sources
    (TreeMonteCarlo::UpdateRadiationField): packets are emitted from the
    sources in proportion to their luminosities, propagated, and

        u_rad = (L_tot / Npacket) * sum(w ds) / (c V_cell).

    Returns (u_rad *ncells, absorbed_rate *ncells, escaped fraction);
    absorbed_rate is energy absorbed per unit time per cell."""
    n_src = r_src.shape[0]
    L_tot = jnp.sum(L_src)
    k1, k2 = jax.random.split(key)
    # emission source sampled proportionally to luminosity
    src = jax.random.choice(k1, n_src, (n_packets,),
                            p=L_src / jnp.maximum(L_tot, 1e-300))
    r0 = r_src[src]
    dirs = isotropic_directions(k2, n_packets, spec.ndim)
    pathlen, absorbed, escaped = propagate_packets(
        spec, opacity_cell, r0, dirs, n_steps, step_frac)
    e_pack = L_tot / n_packets
    v_cell = _cell_volume(spec)
    u_rad = e_pack * pathlen / (c_light * v_cell)
    absorbed_rate = e_pack * absorbed / v_cell
    return u_rad, absorbed_rate, escaped / n_packets


def monochromatic_ionisation_mc(spec, nH_cell: Array, r_src: Array,
                                ndot_src: Array, key, n_packets: int,
                                sigma: float, alphaB: float,
                                n_steps: int = 256, n_iter: int = 8,
                                step_frac: float = 0.5):
    """Monochromatic Monte-Carlo ionisation balance
    (MonochromaticIonisationMonteCarlo): iterate

      opacity = n_H * xHI * sigma  ->  propagate packets  ->
      photoionisations/cell = Ndot_tot/Np * absorbed ->
      xHI from local equilibrium  n_HI Gamma = alphaB n_e n_HII

    with n_e = n_HII = (1 - xHI) n_H.  Returns the per-cell neutral
    fraction xHI (*ncells)."""
    nH = jnp.maximum(nH_cell, 1e-300)

    def one_iter(xHI, k):
        op = nH * xHI * sigma
        _, absorbed, _ = mc_radiation_field(
            spec, op, r_src, ndot_src, k, n_packets, n_steps,
            c_light=1.0, step_frac=step_frac)
        # absorbed = photoionisations per time per volume; the rate PER
        # NEUTRAL ATOM Gamma = absorbed / n_HI is x-independent in the
        # optically-thin limit, which makes the fixed point stable
        # (iterating on the volume rate flips 0 <-> 1)
        gamma = absorbed / (nH * jnp.maximum(xHI, 1e-8))
        # equilibrium x Gamma = alphaB (1-x)^2 n_H: with
        # A = alphaB n_H / Gamma the stable root of A(1-x)^2 = x is
        #   x = 2A / (2A + 1 + sqrt(4A + 1))
        # (exact conjugate form — no cancellation for small A)
        A = alphaB * nH / jnp.maximum(gamma, 1e-300)
        x_new = 2.0 * A / (2.0 * A + 1.0 + jnp.sqrt(4.0 * A + 1.0))
        x_new = jnp.where(gamma <= 0.0, 1.0, x_new)
        # under-relaxation keeps the advancing front monotone (the
        # reference damps its radiation<->ionisation loop the same way)
        return 0.5 * xHI + 0.5 * x_new, None

    keys = jax.random.split(key, n_iter)
    xHI, _ = jax.lax.scan(one_iter,
                          jnp.full_like(nH, 1e-3), keys)
    return xHI
