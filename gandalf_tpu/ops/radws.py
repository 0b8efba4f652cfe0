"""RadWS radiative cooling/heating (Stamatellos et al. 2007).

Vectorisation of EnergyRadws + OpacityTable + Radws EOS
(src/Hydrodynamics/EnergyRadws.cpp:60-745, src/Common/OpacityTable.cpp,
src/Thermal/RadwsEOS.cpp): every particle relaxes exponentially toward a
local radiative-equilibrium energy,

  u(t + dt) = ueq + (u0 - ueq) exp(-dt / dt_therm),

with ueq / dt_therm found from the energy balance

  f(T) = dudt_hydro - 4 sigma (T^4 - T_amb^4) / (col2 kappa(T) + 1/kappa_p(T))

using tabulated opacities.  The reference's per-particle index bisection
becomes a fixed-iteration vectorised bisection on log T; all table lookups
are nearest-index gathers (matching OpacityTable::getClosestIndex).

The opacity table is the reference's 9-column text format
(dens temp energy mu kappa kappar kappap gamma gamma1, dens-major, header
"ndens ntemp fcol"); `make_ideal_table` builds a synthetic ideal-gas +
constant-opacity table for testing.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

RAD_CONST_CGS = 5.670374419e-5     # Stefan-Boltzmann [erg cm^-2 s^-1 K^-4]


class OpacityTable(NamedTuple):
    log_dens: Array      # (nd,) log10 rho grid
    log_temp: Array      # (nt,) log10 T grid
    energy: Array        # (nd, nt) specific internal energy u(rho, T)
    mu: Array            # (nd, nt) mean molecular weight
    kappa: Array         # (nd, nt)
    kappap: Array        # (nd, nt) Planck-mean
    gamma: Array         # (nd, nt)
    fcol2: Array         # () column-density metric factor
    rad_const: Array     # () Stefan-Boltzmann in code units
    temp_min: Array      # ()
    temp_ambient: Array  # ()


def read_opacity_table(path: str, u_scale: float = 1.0,
                       kappa_scale: float = 1.0,
                       rad_const: float = RAD_CONST_CGS,
                       temp_ambient: float = 10.0,
                       temp_min: float = 5.0,
                       lombardi: bool = False) -> OpacityTable:
    """Parse the reference text format (OpacityTable.cpp:48-130)."""
    rows = []
    header = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if header is None:
                header = line.split()
                continue
            vals = line.split()
            if len(vals) >= 9:
                rows.append([float(x) for x in vals[:9]])
    ndens, ntemp, fcol = int(header[0]), int(header[1]), float(header[2])
    arr = np.asarray(rows).reshape(ndens, ntemp, 9)
    fcol2 = fcol * fcol if lombardi else fcol * fcol * 4.0 * np.pi
    return OpacityTable(
        log_dens=jnp.asarray(np.log10(arr[:, 0, 0])),
        log_temp=jnp.asarray(np.log10(arr[0, :, 1])),
        energy=jnp.asarray(arr[:, :, 2] / u_scale),
        mu=jnp.asarray(arr[:, :, 3]),
        kappa=jnp.asarray(arr[:, :, 4] / kappa_scale),
        kappap=jnp.asarray(arr[:, :, 6] / kappa_scale),
        gamma=jnp.asarray(arr[:, :, 7]),
        fcol2=jnp.asarray(fcol2),
        rad_const=jnp.asarray(rad_const),
        temp_min=jnp.asarray(temp_min),
        temp_ambient=jnp.asarray(temp_ambient))


def make_ideal_table(ndens: int = 8, ntemp: int = 128,
                     gamma: float = 5.0 / 3.0, mu_bar: float = 1.0,
                     kappa0: float = 1.0, rad_const: float = 1.0,
                     temp_ambient: float = 10.0, temp_min: float = 1.0,
                     fcol: float = 1.0,
                     logrho_range=(-8.0, 2.0),
                     logtemp_range=(0.0, 5.0)) -> OpacityTable:
    """Synthetic table: ideal gas u = T/((gamma-1) mu), constant opacity.
    Used by the test suite (no physical table ships with the repo)."""
    ld = np.linspace(*logrho_range, ndens)
    lt = np.linspace(*logtemp_range, ntemp)
    T = 10.0 ** lt
    u = T / ((gamma - 1.0) * mu_bar)
    return OpacityTable(
        log_dens=jnp.asarray(ld),
        log_temp=jnp.asarray(lt),
        energy=jnp.asarray(np.broadcast_to(u, (ndens, ntemp)).copy()),
        mu=jnp.full((ndens, ntemp), mu_bar),
        kappa=jnp.full((ndens, ntemp), kappa0),
        kappap=jnp.full((ndens, ntemp), kappa0),
        gamma=jnp.full((ndens, ntemp), gamma),
        fcol2=jnp.asarray(fcol * fcol * 4.0 * np.pi),
        rad_const=jnp.asarray(rad_const),
        temp_min=jnp.asarray(temp_min),
        temp_ambient=jnp.asarray(temp_ambient))


def _closest_index(grid: Array, x: Array) -> Array:
    """Nearest grid index (OpacityTable::getClosestIndex)."""
    hi = jnp.searchsorted(grid, x)
    hi = jnp.clip(hi, 1, grid.shape[0] - 1)
    lo = hi - 1
    pick_hi = (x - grid[lo]) > (grid[hi] - x)
    return jnp.where(pick_hi, hi, lo)


def idens_of(table: OpacityTable, rho: Array) -> Array:
    return _closest_index(table.log_dens,
                          jnp.log10(jnp.maximum(rho, 1e-30)))


def itemp_of(table: OpacityTable, temp: Array) -> Array:
    return _closest_index(table.log_temp,
                          jnp.log10(jnp.maximum(temp, 1e-30)))


def temp_from_u(table: OpacityTable, rho: Array, u: Array) -> Array:
    """Invert the (monotone-in-T) energy table (GetIEner + eos_temp).
    Shape-polymorphic: rho/u may be (N,) or dense cell tensors
    (*ncells, K) — the grid27 EOS update passes the latter."""
    idens = idens_of(table, rho)
    rows = table.energy[idens]                 # (*shape, nt)
    it = jnp.sum(rows < u[..., None], axis=-1)
    it = jnp.clip(it, 1, rows.shape[-1] - 1)
    lo = it - 1
    u_lo = jnp.take_along_axis(rows, lo[..., None], axis=-1)[..., 0]
    u_hi = jnp.take_along_axis(rows, it[..., None], axis=-1)[..., 0]
    pick_hi = (u - u_lo) > (u_hi - u)
    ii = jnp.where(pick_hi, it, lo)
    return 10.0 ** table.log_temp[ii]


def _ebalance(table: OpacityTable, dudt, temp_ex, temp, kappa, kappap,
              col2):
    """Radiative heating/cooling rate (EnergyRadws.cpp:709-718)."""
    return dudt - 4.0 * table.rad_const * (temp ** 4 - temp_ex ** 4) \
        / (col2 * kappa + 1.0 / kappap)


def energy_find_equi(table: OpacityTable, rho: Array, u: Array,
                     dudt: Array, col2: Array, n_iter: int = 30,
                     temp_amb: Array = None):
    """(ueq, dt_therm) per particle: bisect f(T) = dudt + ebalance on the
    tabulated temperature range (EnergyFindEqui/EnergyFindEquiTemp,
    EnergyRadws.cpp:340-700).  f is decreasing in T."""
    idens = idens_of(table, rho)
    temp = temp_from_u(table, rho, u)
    if temp_amb is None:
        temp_amb = table.temp_ambient   # radiative-FB passes a field

    def f_of(T):
        it = itemp_of(table, T)
        kap = table.kappa[idens, it]
        kp = table.kappap[idens, it]
        return _ebalance(table, dudt, temp_amb, T, kap, kp, col2)

    t_lo = jnp.broadcast_to(table.temp_min, rho.shape)
    t_hi = jnp.broadcast_to(10.0 ** table.log_temp[-1], rho.shape)
    f_lo = f_of(t_lo)
    f_hi = f_of(t_hi)
    lo = jnp.log10(t_lo)
    hi = jnp.log10(t_hi)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        fm = f_of(10.0 ** mid)
        take_lo = fm > 0.0       # root is above mid (f decreasing)
        lo = jnp.where(take_lo, mid, lo)
        hi = jnp.where(take_lo, hi, mid)
    tequi = 10.0 ** (0.5 * (lo + hi))
    # clamp: net cooling below the floor -> T_min; net heating beyond the
    # table -> top of the table (reference clamps the same way)
    tequi = jnp.where(f_lo <= 0.0, t_lo, jnp.where(f_hi >= 0.0, t_hi,
                                                   tequi))

    it_eq = itemp_of(table, tequi)
    ueq = table.energy[idens, it_eq]
    # radiative rate at the CURRENT temperature (EnergyRadws.cpp:368-380)
    it_now = itemp_of(table, temp)
    kap = table.kappa[idens, it_now]
    kp = table.kappap[idens, it_now]
    dudt_rad = _ebalance(table, 0.0, temp_amb, temp, kap, kp, col2)
    denom = dudt + dudt_rad
    dt_therm = jnp.where(jnp.abs(denom) > 1e-30,
                         (ueq - u) / jnp.where(denom == 0, 1.0, denom),
                         1e30)
    dt_therm = jnp.where(dt_therm < 0.0, 1e30, dt_therm)
    return ueq, dt_therm


def radws_energy_integration(u0: Array, ueq: Array, dt_therm: Array,
                             dt: Array) -> Array:
    """Exponential relaxation toward equilibrium
    (EnergyRadws::EnergyIntegration, EnergyRadws.cpp:108-147)."""
    x = dt / jnp.maximum(dt_therm, 1e-30)
    decay = jnp.exp(-jnp.minimum(x, 40.0))
    u = u0 * decay + ueq * (1.0 - decay)
    u = jnp.where(x >= 40.0, ueq, u)
    return jnp.where(dt_therm <= 1e-30, u0, u)


def radws_col2(table: OpacityTable, rho: Array, gpot: Array) -> Array:
    """Column-density-squared metric, RadWS variant: fcol2 gpot rho
    (EnergyRadws::GetCol2, EnergyRadws.cpp:729-735; gpot is the positive
    smoothed potential)."""
    return table.fcol2 * gpot * rho


def u_of_temp(table: OpacityTable, rho: Array, temp: Array) -> Array:
    """Tabulated u(rho, T) (OpacityTable::GetEnergy)."""
    return table.energy[idens_of(table, rho), itemp_of(table, temp)]


def radws_implicit_heating(table: OpacityTable, rho: Array, u: Array,
                           dudt: Array, col2: Array, dt: Array,
                           temp_amb: Array = None,
                           n_iter: int = 40) -> Array:
    """Implicit radiative heating rate for the MeshlessFV energy update
    (EnergyRadws::ImplicitEnergyUpdate, EnergyRadws.cpp:546-640):
    solve u' = u + dt (dudt + heating(u')) by bisecting
    g(T) = u(T) - u - dt * ebalance(dudt, T_amb, T, kappa(T), kappap(T),
    col2) = 0 on the tabulated temperature range (g increasing in T),
    and return heating = ebalance at the root.  The caller clips the
    rate and folds m * heating into the total-energy conserved variable
    (reference part.cooling, MfvIntegration.cpp:88-89)."""
    idens = idens_of(table, rho)
    if temp_amb is None:
        temp_amb = table.temp_ambient

    def g_of(T):
        it = itemp_of(table, T)
        kap = table.kappa[idens, it]
        kp = table.kappap[idens, it]
        heat = _ebalance(table, dudt, temp_amb, T, kap, kp, col2)
        # continuous u(T) through the local (mu, gamma) like the
        # reference's bracket evaluation (EnergyRadws.cpp:586-607:
        # balance = T/(mu (gamma-1)) - u - heating dt)
        u_T = T / (table.mu[idens, it]
                   * (table.gamma[idens, it] - 1.0))
        return u_T - u - dt * heat, heat

    t_lo = jnp.broadcast_to(table.temp_min, rho.shape)
    t_hi = jnp.broadcast_to(10.0 ** table.log_temp[-1], rho.shape)
    g_lo, h_lo = g_of(t_lo)
    g_hi, h_hi = g_of(t_hi)
    lo = jnp.log10(t_lo)
    hi = jnp.log10(t_hi)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        gm, _ = g_of(10.0 ** mid)
        take_hi = gm < 0.0            # root above mid (g increasing)
        lo = jnp.where(take_hi, mid, lo)
        hi = jnp.where(take_hi, hi, mid)
    t_root = 10.0 ** (0.5 * (lo + hi))
    _, heat = g_of(t_root)
    # clamps: net cooling below the floor / heating beyond the table use
    # the edge rates (the reference clamps T the same way)
    heat = jnp.where(g_lo >= 0.0, h_lo, jnp.where(g_hi <= 0.0, h_hi,
                                                  heat))
    return heat
