"""Parameter system: `.dat` parameter-file grammar and full default table.

Grammar-compatible with the reference config system
(src/Common/Parameters.cpp:75-155): each line is
``Description text : key = value``; all spaces are stripped, lines starting
with ``#`` (after stripping) are comments, lines without ``=`` or with the
``:`` after the ``=`` are ignored, and the ``:`` is optional.  Values are
coerced by which typed map (int/float/string) holds the key's default
(src/Common/Parameters.cpp SetParameter); unknown keys warn and are dropped.

The ~300 defaults mirror Parameters::SetDefaultValues
(src/Common/Parameters.cpp:157-).
"""

from __future__ import annotations

import sys
from typing import Dict, Union

# --------------------------------------------------------------------------
# Default values.  Three typed maps exactly as the reference keeps them:
# integers, floats and strings.  (src/Common/Parameters.cpp:157-636)
# --------------------------------------------------------------------------

_INT_DEFAULTS: Dict[str, int] = {
    "ndim": 3,
    "Nstepsmax": 99999999,
    "noutputstep": 128,
    "ndiagstep": 1024,
    "nrestartstep": 512,
    "litesnap": 0,
    "dimensionless": 0,
    "Nlevels": 1,
    "level_diff_max": 1,
    "sph_single_timestep": 0,
    "nbody_single_timestep": 0,
    "conservative_sph_star_gravity": 1,
    # reference default is 1 (table lookups are faster than polynomials on
    # CPU); direct piecewise-polynomial evaluation is exact and fuses into
    # the pair loops, so the default here is direct.  tabulated_kernel = 1
    # reproduces the reference's table quantisation exactly (see
    # kernels.smoothing.TabulatedKernel).
    "tabulated_kernel": 0,
    "hydro_forces": 1,
    "lombardi_method": 0,
    "zero_mass_flux": 1,
    "static_particles": 0,
    "self_gravity": 0,
    "kgrav": 1,
    "Nleafmax": 6,
    # tree-bucket replan cadence; the reference default is 1 (rebuild every
    # step, KDTree::BuildTree is cheap there) but our host-side bucket
    # planning costs ~0.1s/M particles, and stale buckets stay CORRECT
    # (boxes are re-stocked in-jit every step), so the default is 8
    "ntreebuildstep": 8,
    "ntreestockstep": 1,
    # device shards for the distributed (multi-chip) controller; 0 = single
    # device, 1+ = shard over that many devices (reference: mpirun ranks)
    "Nmpi": 0,
    "sub_systems": 0,
    "Npec": 1,
    "nbody_softening": 1,
    "perturbers": 0,
    "binary_stats": 0,
    "nsystembuildstep": 1,
    "sink_particles": 0,
    "create_sinks": 0,
    "smooth_accretion": 0,
    "fixed_sink_mass": 0,
    "extra_sink_output": 0,
    "Nsinkfixed": -1,
    "Nraditerations": 2,
    "Nradlevels": 1,
    "nradstep": 1,
    "on_the_spot": 0,
    "nside": 4,
    "ilNR": 50,
    "ilNTheta": 25,
    "ilNPhi": 50,
    "ilNNS": 20,
    "ilFinePix": 4,
    "cut_box": 0,
    "ewald": 1,
    "gr_bhewaldseriesn": 10,
    "in": 500,
    "nEwaldGrid": 16,
    "use_fixed_spacing": 0,
    "smooth_ic": 0,
    "com_frame": 0,
    "Nreg": 1,
    "field_type": 1,
    "gridsize": 64,
    "Nhydro": 0,
    "Ndust": 0,
    "Nhydromax": -1,
    "Nstar": 0,
    "Nstarmax": -1,
    "Nlattice1[0]": 1,
    "Nlattice1[1]": 1,
    "Nlattice1[2]": 1,
    "Nlattice2[0]": 1,
    "Nlattice2[1]": 1,
    "Nlattice2[2]": 1,
    "regularise_particle_ics": 0,
    "regularise_smooth_density": 1,
    "randseed": 1,
    "pruning_level_min": 6,
    "pruning_level_max": 6,
    "rad_fb": 0,
    "ambient_heating": 0,
    "disc_heating": 0,
    "sink_heating": 0,
    "DiscIcPlanet": 1,
}

_FLOAT_DEFAULTS: Dict[str, float] = {
    "tend": 1.0,
    "tmax_wallclock": 9.99e20,
    "dt_snap": 0.2,
    "tsnapfirst": 0.2,
    "dt_litesnap": 0.2,
    "tlitesnapfirst": 0.0,
    "accel_mult": 0.3,
    "courant_mult": 0.15,
    "nbody_mult": 0.1,
    "subsys_mult": 0.05,
    "visc_mult": 0.3,
    "h_fac": 1.2,
    "h_converge": 0.01,
    "energy_mult": 0.4,
    "gamma_eos": 1.66666666666666,
    "temp0": 1.0,
    "mu_bar": 1.0,
    "tempmin": 0.01,
    "templaw": 0.75,
    "rho_bary": 1.0e-14,
    "eta_eos": 1.4,
    "Kpoly": 1.0,
    "temp_ambient": 5.0,
    "tsupernova": 1.0,
    "Minj": 0.005,
    "Rinj": 0.0,
    "R_therm_kin": 1.0e5,
    "alpha_visc": 1.0,
    "alpha_visc_min": 0.1,
    "beta_visc": 2.0,
    "shear_visc": 0.0,
    "bulk_visc": 0.0,
    "avert": -0.5,
    "rplummer_extpot": 1.0,
    "mplummer_extpot": 1.0,
    "thetamaxsqd": 0.1,
    "macerror": 0.0001,
    "gpefrac": 5.0e-2,
    "gpesoft": 2.0e-2,
    "gpehard": 1.0e-3,
    "rho_sink": 1.0e-12,
    "alpha_ss": 0.01,
    "sink_radius": 2.0,
    "smooth_accrete_frac": 0.01,
    "smooth_accrete_dt": 0.01,
    "Nphotonratio": 8.0,
    "mu_ion": 0.678,
    "temp_ion": 1e4,
    "arecomb": 2.7e-13,
    "Ndotmin": 1e47,
    "NLyC": 1e47,
    "maxDist": 1.0e99,
    "rayRadRes": 1.0,
    "relErr": 0.01,
    "boxmin[0]": -9.9e30,
    "boxmin[1]": -9.9e30,
    "boxmin[2]": -9.9e30,
    "boxmax[0]": 9.9e30,
    "boxmax[1]": 9.9e30,
    "boxmax[2]": 9.9e30,
    "ewald_mult": 1.0,
    "ixmin": 1.0e-8,
    "ixmax": 5.0,
    "EFratio": 1.0,
    "vfluid1[0]": 0.0,
    "vfluid1[1]": 0.0,
    "vfluid1[2]": 0.0,
    "vfluid2[0]": 0.0,
    "vfluid2[1]": 0.0,
    "vfluid2[2]": 0.0,
    "rhofluid1": 1.0,
    "rhofluid2": 1.0,
    "press1": 1.0,
    "press2": 1.0,
    "rexplosion": 0.2,
    "amp": 0.1,
    "lambda": 0.5,
    "kefrac": 0.0,
    "radius": 1.0,
    "angvel": 0.0,
    "omega": 0.0,
    "mcloud": 1.0,
    "mplummer": 1.0,
    "rplummer": 1.0,
    "rstar": 0.1,
    "cdmfrac": 0.0,
    "gasfrac": 0.0,
    "starfrac": 1.0,
    "m1": 0.5,
    "m2": 0.5,
    "m3": 0.5,
    "m4": 0.5,
    "abin": 1.0,
    "abin2": 0.1,
    "ebin": 0.0,
    "ebin2": 0.0,
    "phirot": 0.0,
    "thetarot": 0.0,
    "psirot": 0.0,
    "vmachbin": 1.0,
    "alpha_turb": 0.1,
    "power_turb": -4.0,
    "asound": 1.0,
    "zmax": 1.0,
    "thermal_energy": 1.0,
    "mach": 2.7,
    "DiscIcStarMass": 1.0,
    "DiscIcMass": 0.01,
    "DiscIcP": 1.0,
    "DiscIcQ": 0.5,
    "DiscIcRin": 0.4,
    "DiscIcRout": 2.5,
    "DiscIcHr": 0.05,
    "DiscIcPlanetRadius": 1.0,
    "DiscIcPlanetMass": 1e-3,
    "DiscIcPlanetAccretionRadiusHill": 0.4,
    "DiscIcPlanetEccen": 0.0,
    "DiscIcPlanetIncl": 0.0,
    "DustGasRatio": 0.01,
    "alpha_reg": 0.1,
    "rho_reg": 0.8,
    "a_midplane": 1.0,
    "h_midplane": 1.0,
    "rho_midplane": 1.0,
    "rho_star": 1.0,
    "sigma_star": 30.0,
    "z_d": 100.0,
    "n0": 7.1e4,
    "r0": 0.027,
    "Rfilament": 0.075,
    "Lfilament": 1.6,
    "v_cyl_infall": 0.0,
    "v_rad_infall": 0.0,
    "dt_python": 8.0,
    "drag_coeff": 0.0,
    "dust_mass_factor": 1.0,
    "r_smooth": 0.01,
    "temp_q": 0.75,
    "temp_q_secondary": 0.75,
    "temp_au": 250.0,
    "temp_au_secondary": 250.0,
    "f_acc": 0.75,
    "r_star": 3.0,
    "r_bdwarf": 0.2,
    "r_planet": 0.075,
}

_STRING_DEFAULTS: Dict[str, str] = {
    "sim": "sph",
    "sph": "gradh",
    "nbody": "hermite4",
    "ic": "box",
    "run_id": "",
    "in_file": "",
    "in_file_form": "su",
    "out_file_form": "su",
    "rinunit": "",
    "minunit": "",
    "tinunit": "",
    "vinunit": "",
    "ainunit": "",
    "rhoinunit": "",
    "sigmainunit": "",
    "pressinunit": "",
    "finunit": "",
    "Einunit": "",
    "mominunit": "",
    "angmominunit": "",
    "angvelinunit": "",
    "dmdtinunit": "",
    "Linunit": "",
    "kappainunit": "",
    "Binunit": "",
    "Qinunit": "",
    "Jcurinunit": "",
    "uinunit": "",
    "dudtinunit": "",
    "tempinunit": "",
    "routunit": "pc",
    "moutunit": "m_sun",
    "toutunit": "myr",
    "voutunit": "km_s",
    "aoutunit": "km_s2",
    "rhooutunit": "g_cm3",
    "sigmaoutunit": "m_sun_pc2",
    "pressoutunit": "Pa",
    "foutunit": "N",
    "Eoutunit": "J",
    "momoutunit": "m_sunkm_s",
    "angmomoutunit": "m_sunkm2_s",
    "angveloutunit": "rad_s",
    "dmdtoutunit": "m_sun_yr",
    "Loutunit": "L_sun",
    "kappaoutunit": "m2_kg",
    "Boutunit": "tesla",
    "Qoutunit": "C",
    "Jcuroutunit": "C_s_m2",
    "uoutunit": "J_kg",
    "dudtoutunit": "J_kg_s",
    "tempoutunit": "K",
    "sph_integration": "lfkdk",
    "kernel": "m4",
    "gas_eos": "energy_eqn",
    "energy_integration": "null",
    "radws_table": "eos.bell.cc.dat",
    "avisc": "mon97",
    "acond": "none",
    "time_dependent_avisc": "none",
    "riemann_solver": "hllc",
    "slope_limiter": "gizmo",
    "time_step_limiter": "none",
    "grav_kernel": "mean_h",
    "external_potential": "none",
    "neib_search": "kdtree",
    "gravity_mac": "geometric",
    "multipole": "quadrupole",
    "sub_system_integration": "hermite4",
    "sink_radius_mode": "hmult",
    "radiation": "none",
    "errControl": "erad_tot",
    "boundary_lhs[0]": "open",
    "boundary_rhs[0]": "open",
    "boundary_lhs[1]": "open",
    "boundary_rhs[1]": "open",
    "boundary_lhs[2]": "open",
    "boundary_rhs[2]": "open",
    "particle_distribution": "cubic_lattice",
    "rand_algorithm": "xorshift",
    "mpi_decomposition": "kdtree",
    "dust_forces": "none",
    "drag_law": "none",
    "supernova_feedback": "none",
    "SNfile_name": "",
    "sink_fb": "continuous",
}


class Parameters:
    """Typed key/value parameter store with `.dat`-file reader.

    Mirrors the public behaviour of the reference `Parameters` class
    (src/Headers/Parameters.h:41-61): three typed maps, defaults preloaded,
    string values coerced on assignment by which map owns the key.
    """

    def __init__(self) -> None:
        self.intparams: Dict[str, int] = dict(_INT_DEFAULTS)
        self.floatparams: Dict[str, float] = dict(_FLOAT_DEFAULTS)
        self.stringparams: Dict[str, str] = dict(_STRING_DEFAULTS)

    # -- file reading -------------------------------------------------------
    def read_file(self, filename: str) -> None:
        """Parse a parameter file (reference Parameters::ReadParamsFile)."""
        with open(filename, "r") as f:
            for line in f:
                self.parse_line(line)
        if self.stringparams["run_id"] == "":
            raise ValueError(
                f"The parameter file {filename} does not contain a run id string"
            )
        self.check_invalid_parameters()

    # Alias matching the reference method name, for facade parity.
    ReadParamsFile = read_file

    def parse_line(self, line: str) -> None:
        """Parse one ``Description : key = value`` line.

        Same tolerant grammar as Parameters::ParseLine: strip ALL spaces,
        skip '#'-leading lines, require '=', allow a missing ':' and ignore
        lines whose ':' falls after the '='.
        """
        stripped = "".join(ch for ch in line if not ch.isspace())
        if not stripped or stripped.startswith("#"):
            return
        eq = stripped.find("=")
        if eq < 0:
            return
        colon = stripped.find(":")
        if colon > eq:
            return
        key = stripped[colon + 1 : eq]
        value = stripped[eq + 1 :]
        # Strip trailing inline comments ("value  # note"), which the
        # reference tolerates only when the '#' survives into the value.
        hash_pos = value.find("#")
        if hash_pos >= 0:
            value = value[:hash_pos]
        self.set(key, value)

    # -- typed get/set ------------------------------------------------------
    def set(self, key: str, value: Union[str, int, float]) -> None:
        if key in self.intparams:
            sv = str(value).strip().lower()
            # the reference's .dat files use true/false for int toggles
            # (e.g. `dimensionless = false`, examples/bossbodenheimer.dat)
            if sv in ("true", "false"):
                value = 1 if sv == "true" else 0
            self.intparams[key] = int(float(str(value)))
        elif key in self.floatparams:
            self.floatparams[key] = float(str(value))
        elif key in self.stringparams:
            self.stringparams[key] = str(value)
        else:
            print(f"Warning: parameter {key} was not recognized", file=sys.stderr)

    SetParameter = set

    def get(self, key: str) -> Union[str, int, float]:
        for m in (self.intparams, self.floatparams, self.stringparams):
            if key in m:
                return m[key]
        raise KeyError(key)

    def __getitem__(self, key: str) -> Union[str, int, float]:
        return self.get(key)

    def __setitem__(self, key: str, value: Union[str, int, float]) -> None:
        self.set(key, value)

    def __contains__(self, key: str) -> bool:
        return (
            key in self.intparams
            or key in self.floatparams
            or key in self.stringparams
        )

    # -- validation ---------------------------------------------------------
    def check_invalid_parameters(self) -> None:
        """Reject parameter combinations the reference refuses to run.

        (src/Common/Parameters.cpp CheckInvalidParameters — currently only
        the disabled sm2012sph simulation type.)
        """
        if self.stringparams["sim"] == "sm2012sph":
            raise ValueError(
                "Saitoh & Makino (2012) SPH algorithm currently disabled"
            )

    # -- recording ----------------------------------------------------------
    def record_to_file(self, filename: str) -> None:
        """Write every parameter as ``key = value`` (Parameters.cpp:639)."""
        with open(filename, "w") as f:
            for m in (self.intparams, self.floatparams, self.stringparams):
                for k in sorted(m):
                    f.write(f"{k} = {m[k]}\n")

    def copy(self) -> "Parameters":
        out = Parameters()
        out.intparams = dict(self.intparams)
        out.floatparams = dict(self.floatparams)
        out.stringparams = dict(self.stringparams)
        return out
