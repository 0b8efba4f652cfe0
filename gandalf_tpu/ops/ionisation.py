"""Photoionisation from point sources.

Vectorised re-design of MultipleSourceIonisation
(src/Thermal/MultipleSourceIonisation.cpp:55-769).  The reference walks
per-particle neighbour CHAINS toward each source and depletes the photon
budget along them — a serial, pointer-chasing scheme.  Here the same
physical balance (ionising rate vs cumulative recombination) is evaluated
with a radial Stromgren integral per source, which is exact for the
spherically-averaged problem and fully vectorises:

  particles are ranked by distance from the source; the cumulative
  recombination rate R(<r) = sum_j alphaB (rho_j / (mu m_H))^2 (m_j/rho_j)
  is compared with the source's ionising rate Ndot; particles inside the
  radius where R(<r) = Ndot are flagged ionised.

Ionised gas is set to the ionised temperature ti (mu_ion), neutral gas to
tn (mu_bar); the smoothed ionisation fraction gives the usual blended
temperature at the front (ionisation_intergration:225-700 behaviour).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class IonisationConfig:
    """Parameters of the reference scheme (ProcessParameters names)."""

    temp_ion: float = 10000.0      # ti
    temp_neutral: float = 10.0     # tn
    mu_ion: float = 0.678
    mu_bar: float = 2.35
    alphaB: float = 2.7e-13        # case-B recombination (code units)
    Ndotmin: float = 0.0


def ionisation_fractions(cfg: IonisationConfig,
                         r: Array, m: Array, rho: Array,
                         r_src: Array, ndot_src: Array,
                         active_src: Array) -> Array:
    """(N,) ionisation flags: 1 where ANY source's photon budget reaches
    the particle (radial Stromgren balance per source)."""
    n_H = rho / cfg.mu_bar                       # number density
    rec_rate = cfg.alphaB * n_H * n_H * (m / jnp.maximum(rho, 1e-30))

    def one_source(rs, ndot, act):
        d = jnp.sqrt(jnp.sum((r - rs[None, :]) ** 2, axis=-1))
        order = jnp.argsort(d)
        cum = jnp.cumsum(rec_rate[order])
        # ionised prefix: cumulative recombination within the budget
        ion_sorted = cum <= ndot
        ion = jnp.zeros_like(ion_sorted).at[order].set(ion_sorted)
        return ion & act & (ndot > cfg.Ndotmin)

    import jax

    ion_per_src = jax.vmap(one_source)(r_src, ndot_src, active_src)
    return jnp.any(ion_per_src, axis=0)


def multi_source_ionisation(cfg: IonisationConfig,
                            r: Array, m: Array, rho: Array,
                            r_src: Array, ndot_src: Array,
                            active_src: Array, n_iter: int = 8) -> Array:
    """Iterated COUPLED multi-source ionisation balance
    (MultipleSourceIonisation.cpp:55-769).

    Where HII regions overlap, a particle's recombination must not be
    charged in full to every source (the independent per-source balance
    under-ionises merged regions).  The reference iterates a probabilistic
    assignment; here each particle's recombination is split between the
    sources currently reaching it in proportion to the delivered flux
    Ndot_s / (4 pi d_ps^2), and the per-source Stromgren prefixes are
    re-solved until the assignment is self-consistent:

        w_ps = F_ps / sum_s' F_ps'        (over sources reaching p)
        R(<r)_s = cumsum_d [w_ps rec_p] <= Ndot_s  ->  new reach set

    Single isolated source: converges to the radial Stromgren balance in
    one pass (identical to ionisation_fractions).
    """
    import jax

    n_H = rho / cfg.mu_bar
    rec = cfg.alphaB * n_H * n_H * (m / jnp.maximum(rho, 1e-30))
    src_on = active_src & (ndot_src > cfg.Ndotmin)

    d = jnp.sqrt(jnp.sum(
        (r[None, :, :] - r_src[:, None, :]) ** 2, axis=-1))   # (S, N)
    order = jnp.argsort(d, axis=1)                            # static sorts
    rank = jnp.zeros_like(order).at[
        jnp.arange(order.shape[0])[:, None], order].set(
        jnp.broadcast_to(jnp.arange(order.shape[1]), order.shape))

    def solve(weights):
        """Per-source ionised sets from weighted recombination prefixes."""
        w_rec = weights * rec[None, :]                        # (S, N)
        w_sorted = jnp.take_along_axis(w_rec, order, axis=1)
        cum = jnp.cumsum(w_sorted, axis=1)
        ion_sorted = cum <= ndot_src[:, None]
        reach = jnp.take_along_axis(ion_sorted, rank, axis=1)
        return reach & src_on[:, None]

    # start from the independent (full-charge) solution
    reach = solve(jnp.ones_like(d))

    def body(_, reach):
        flux = jnp.where(reach, ndot_src[:, None]
                         / jnp.maximum(d * d, 1e-30), 0.0)
        tot = jnp.sum(flux, axis=0)                           # (N,)
        w = jnp.where(tot[None, :] > 0.0,
                      flux / jnp.maximum(tot[None, :], 1e-300), 1.0)
        return solve(w)

    reach = jax.lax.fori_loop(0, n_iter, body, reach)
    return jnp.any(reach, axis=0)


def apply_ionisation(cfg: IonisationConfig, gammam1: float,
                     ionised: Array, u: Array) -> Tuple[Array, Array]:
    """Internal energies for ionised/neutral gas
    (temperature floors; the reference resets u from the blended
    temperature).  Returns (u_new, temp)."""
    u_ion = cfg.temp_ion / (gammam1 * cfg.mu_ion)
    u_neu = cfg.temp_neutral / (gammam1 * cfg.mu_bar)
    u_new = jnp.where(ionised, jnp.maximum(u, u_ion),
                      jnp.maximum(u, u_neu))
    temp = jnp.where(ionised, cfg.temp_ion, cfg.temp_neutral)
    return u_new, temp


def stromgren_radius(ndot: float, n_H: float, alphaB: float) -> float:
    """Analytic uniform-density Stromgren radius (test oracle)."""
    import numpy as np

    return (3.0 * ndot / (4.0 * np.pi * alphaB * n_H * n_H)) ** (1.0 / 3.0)
