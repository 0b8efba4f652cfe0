"""Distributed (multi-chip) meshless finite-volume controller.

MfvMusclSimulation over the sharded z-slab runtime (the reference's MPI
mode covers the MeshlessFV flavours through the same MpiControl /
pruned-tree machinery as SPH, src/MeshlessFV/MeshlessFVSimulation.cpp +
src/Mpi/MpiControl.cpp): the three dense grid passes
(ops/mfv_grid27.py) run shard-local with ppermute halo rings, gravity
walks the replicated bucket tree with the MFV zeta scaling, and dt is a
pmin reduction — all inside one jitted shard_map step.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from ..ops import mfv as mfv_ops
from ..parallel import dist
from ..state import MfvState
from .dist_sim import DistributedGradhSphSimulation as _DistGradh
from .mfv_sim import MfvMusclSimulation


class DistributedMfvSimulation(MfvMusclSimulation):
    def process_parameters(self):
        super().process_parameters()
        p = self.params
        self.n_shards = p.intparams["Nmpi"]
        n_dev = len(jax.devices())
        if self.n_shards <= 1:
            self.n_shards = n_dev
        if self.n_shards > n_dev:
            raise ValueError(f"Nmpi={self.n_shards} > {n_dev} devices")
        if self.box.mirror_walls() and self.neib_search != "bruteforce":
            # the base class routes mirror walls to the single-chip
            # all-pairs image path; the SHARDED MFV kernels carry
            # image-cell support (parallel/dist._dist_mfv_binning), so
            # re-enable the grid path here
            self.use_celllist = True
        if not self.use_celllist:
            raise NotImplementedError(
                "distributed MFV does not yet support: "
                "bruteforce neighbour search")

    # -- planning (borrowed from the SPH dist controller) ------------------
    def _plan_all(self, r_np: np.ndarray, h_np: np.ndarray,
                  growth: float = 1.3):
        from ..ops.sph_grid27 import plan_grid27

        h_max = float(h_np.max()) * growth
        self.gridspec = plan_grid27(self.box, r_np, h_max,
                                    self.kern.kernrange,
                                    z_multiple=self.n_shards)
        self.distplan = dist.plan_decomposition(self.gridspec, r_np,
                                                self.n_shards,
                                                balance="auto")

    def _plan_dist_tree(self, r_sharded: np.ndarray):
        """MFV gravity always walks the REPLICATED bucket tree (the LET
        decomposition currently carries the SPH zeta scaling only)."""
        p = self.params
        self.letplan = None
        _DistGradh._plan_replicated_tree(
            self, r_sharded, p.stringparams["multipole"],
            p.floatparams["thetamaxsqd"])

    def _sharded_lead_dims(self):
        return {self.state.N}

    _dist_specs = _DistGradh._dist_specs
    _sched_specs = _DistGradh._sched_specs
    _place = _DistGradh._place

    # -- sharded step ------------------------------------------------------
    def _dist_gravity(self, s: MfvState, alive):
        box = self.box
        pdims = box.periodic_dims()
        pext = [box.size[k] if k in pdims else 0.0
                for k in range(s.ndim)] if pdims else None
        return dist.dist_tree_gravity(
            self.treespec, s.bucket_map, s, self.kern, alive,
            self.distplan.n_shards, periodic_extent=pext,
            zeta_scaling="mfv")

    def _dist_dt(self, s: MfvState, alive):
        dt = 2.0 * self.courant_mult * s.h \
            / jnp.maximum(s.vsig_max, 1e-30)
        if self.self_gravity:
            amag = jnp.sqrt(jnp.sum(s.a * s.a, axis=-1))
            dt = jnp.minimum(dt, self.accel_mult
                             * jnp.sqrt(s.h / (amag + 1e-30)))
        return lax.pmin(jnp.min(jnp.where(alive, dt, 1e30)), "dp")

    def _build_dist_step(self, bootstrap: bool):
        box, plan = self.box, self.distplan
        kern, eos, cfg = self.kern, self.eos, self.mfv_cfg
        h_fac, h_conv = self.h_fac, self.h_converge
        ndim = self.ndim

        def dens(s, alive):
            return dist.dist_mfv_density_pass(plan, kern, box, h_fac,
                                              h_conv, eos, s, alive)

        def grads(s, alive):
            return dist.dist_mfv_gradient_pass(
                plan, kern, box, s, alive,
                limiter=self.mfv_cfg.slope_limiter)

        def local_fn(s: MfvState) -> MfvState:
            alive = s.alive
            if bootstrap:
                s = dens(s, alive)
                Q0 = mfv_ops.qcons_from_state(ndim, s.m, s.v, s.u)
                s = s.replace(Qcons0=Q0, r0=s.r, v0=s.v)
                if self.self_gravity:
                    a, gpot, ovf = self._dist_gravity(s, alive)
                    s = s.replace(a=a, a0=a, gpot=gpot,
                                  neib_overflow=s.neib_overflow | ovf)
                s = grads(s, alive)
                return s.replace(dt=self._dist_dt(s, alive))
            dt = s.dt
            t = s.t + dt
            flux = dist.dist_mfv_flux_pass(plan, kern, cfg, box, dt, s,
                                           alive)
            Qcons = s.Qcons0 + flux.dQdt * dt
            if self.self_gravity:
                m_new = Qcons[..., ndim]
                v_mid = Qcons[..., :ndim] \
                    / jnp.maximum(m_new, 1e-30)[:, None]
                r = box.wrap(s.r0 + 0.5 * (s.v0 + v_mid) * dt)
                r, v_mid = box.reflect(r, v_mid)
                s_mid = s.replace(r=r, m=m_new)
                a, gpot, ovf = self._dist_gravity(s_mid, alive)
                s = s.replace(neib_overflow=s.neib_overflow | ovf)
                rdmdt = flux.rdmdt_dot * dt
                Qcons = mfv_ops.gravity_source_terms(
                    ndim, dt, s.Qcons0, Qcons, s.a0, a, rdmdt)
                if self.use_radws_energy:
                    # pointwise table lookups + bisection — shards
                    # trivially (EnergyRadws<MeshlessFVParticle>)
                    Qcons = self._apply_radws_cooling(Qcons, s.ndens,
                                                      gpot, dt)
                m, rho, v, u = mfv_ops.state_from_qcons(ndim, Qcons,
                                                        s.ndens)
                s = s.replace(m=m, v=v, u=u, r=r, Qcons0=Qcons,
                              r0=r, v0=v, a=a, a0=a, gpot=gpot)
            else:
                if self.use_radws_energy:
                    Qcons = self._apply_radws_cooling(Qcons, s.ndens,
                                                      s.gpot, dt)
                m, rho, v, u = mfv_ops.state_from_qcons(ndim, Qcons,
                                                        s.ndens)
                r = box.wrap(s.r0 + 0.5 * (s.v0 + v) * dt)
                # mirror walls: reflect escapers with flipped normal
                # velocity; Qcons momentum follows (matches the
                # single-chip step, sim/mfv_sim.py:469-476)
                r, v = box.reflect(r, v)
                Qcons = Qcons.at[..., :ndim].set(
                    v * jnp.maximum(Qcons[..., ndim], 1e-30)[:, None])
                s = s.replace(m=m, v=v, u=u, r=r, Qcons0=Qcons,
                              r0=r, v0=v)
            s = dens(s, alive)
            s = grads(s, alive)
            return s.replace(t=t, dt=self._dist_dt(s, alive),
                             nstep=s.nstep + 1)

        specs = self._dist_specs()
        sm = shard_map(local_fn, mesh=self.mesh, in_specs=(specs,),
                       out_specs=specs, check_vma=False)
        return jax.jit(sm)

    def _build_dist_block(self, bootstrap: bool):
        """Hierarchical block timesteps over the sharded MFV runtime (the
        reference runs the MeshlessFV flavours block-stepped under MPI
        through the same ComputeBlockTimesteps machinery,
        src/Common/Simulation.cpp:1763-2197 + MfvIntegration.cpp):
        per-particle levels/flux accumulators shard with the particles,
        the scalar ladder reductions are pmin/pmax inside the tick, the
        block flux pass ships dt_own/start through the halo ppermutes so
        dt_pair is exact across slab seams, and the conservative
        distant-vsig walk all_gathers per-cell aggregates for its global
        far-field bound."""
        from ..integrate.block import BlockConfig
        from ..integrate.mfv_block import (advance_mfv,
                                           check_timesteps_mfv,
                                           end_timestep_mfv,
                                           init_schedule_mfv)

        box, plan = self.box, self.distplan
        kern, eos, cfg = self.kern, self.eos, self.mfv_cfg
        h_fac, h_conv = self.h_fac, self.h_converge
        bcfg = BlockConfig(nlevels=self.nlevels,
                           level_diff_max=self.level_diff_max)

        def dens(s, alive):
            return dist.dist_mfv_density_pass(plan, kern, box, h_fac,
                                              h_conv, eos, s, alive)

        def grads(s, alive):
            return dist.dist_mfv_gradient_pass(
                plan, kern, box, s, alive,
                limiter=self.mfv_cfg.slope_limiter)

        def dt_crit_part(s, alive):
            vsig = s.vsig_max
            if self.time_step_limiter == "conservative":
                vsig = jnp.maximum(vsig, dist.dist_mfv_vsig_pass(
                    plan, kern, box, s, alive))
            return self._dt_criterion_part(s.replace(vsig_max=vsig))

        def local_boot(s: MfvState):
            alive = s.alive
            s = dens(s, alive)
            Q0 = mfv_ops.qcons_from_state(self.ndim, s.m, s.v, s.u)
            s = s.replace(Qcons0=Q0, r0=s.r, v0=s.v)
            if self.self_gravity:
                a, gpot, ovf = self._dist_gravity(s, alive)
                s = s.replace(a=a, a0=a, gpot=gpot,
                              neib_overflow=s.neib_overflow | ovf)
            s = grads(s, alive)
            s, sched = init_schedule_mfv(bcfg, s, dt_crit_part(s, alive),
                                         axis_name="dp")
            return s.replace(dt=sched.dt_base), sched

        def local_tick(s: MfvState, B):
            alive = s.alive
            # ---- flux pass for starting pairs (UpdateGodunovFluxes) ----
            start = (B.n == s.nlast) & alive
            dt_own = B.dt_base * B.nstep_part.astype(s.m.dtype)
            flux = dist.dist_mfv_flux_pass(plan, kern, cfg, box,
                                           B.dt_base, s, alive,
                                           block=(start, dt_own))
            s = s.replace(
                dQ=s.dQ + flux.dQ,
                rdmdt=s.rdmdt + flux.rdmdt,
                dQdt=jnp.where(start[:, None], flux.dQdt, s.dQdt))
            # ---- advance: predict conserved state + drift all ----------
            s, active, t, _ = advance_mfv(s, B)
            r = box.wrap(s.r)
            r, v = box.reflect(r, s.v)
            rho = s.m * s.ndens
            u, pressure, sound = eos.thermal_update(
                jnp.maximum(rho, 1e-30), s.u)
            s = s.replace(r=r, v=v, rho=rho, u=u, pressure=pressure,
                          sound=sound)
            # ---- Saitoh-Makino simple limiter --------------------------
            if self.time_step_limiter == "simple":
                active, nstep_p, level, s = check_timesteps_mfv(
                    bcfg, s, B, active)
            else:
                nstep_p, level = B.nstep_part, s.level
            # ---- dense density / gravity refresh -----------------------
            s = dens(s, alive)
            if self.self_gravity:
                a, gpot, ovf = self._dist_gravity(s, alive)
                s = s.replace(a=a, gpot=gpot,
                              neib_overflow=s.neib_overflow | ovf)
            s = s.replace(levelneib=dist.dist_levelneib_pass(
                plan, kern, box, s, alive))
            # ---- timestep criterion (+ conservative limiter) -----------
            dt_crit = dt_crit_part(s, alive)
            # ---- commit enders + ladder (EndTimestep) ------------------
            cooling = (self._apply_radws_cooling
                       if self.use_radws_energy else None)
            s, B = end_timestep_mfv(bcfg, eos, s, B, active, level,
                                    nstep_p, dt_crit, t,
                                    axis_name="dp", cooling_fn=cooling)
            # ---- gradients for the NEXT tick's fluxes ------------------
            s = grads(s, alive)
            return s.replace(nstep=s.nstep + 1), B

        specs = self._dist_specs()
        sspecs = self._sched_specs()
        if bootstrap:
            fn, in_specs = local_boot, (specs,)
        else:
            fn, in_specs = local_tick, (specs, sspecs)
        out_specs = (specs, sspecs)
        sm = shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
        return jax.jit(sm)

    def _compile(self):
        build = self._build_dist_block if self.use_block \
            else self._build_dist_step
        self._step_fn = build(bootstrap=False)
        self._bootstrap_fn = build(bootstrap=True)

    def _run_dist(self, bootstrap: bool):
        fn = self._bootstrap_fn if bootstrap else self._step_fn
        if self.use_block:
            if bootstrap:
                self.state, self._blocksched = fn(self.state)
            else:
                self.state, self._blocksched = fn(self.state,
                                                  self._blocksched)
        else:
            self.state = fn(self.state)

    # -- host lifecycle ----------------------------------------------------
    def SetupSimulation(self):
        from ..state import make_mfv_state
        from .ic import generate_ic

        with self.timing.block("SETUP"):
            self.process_parameters()
            self.mesh = dist.make_mesh(self.n_shards)
            ic = generate_ic(self.params, self.eos)
            state = make_mfv_state(ic["r"], ic["v"], ic["m"], ic["h"],
                                   ic["u"])
            self._n_orig = state.N
            self._plan_all(np.asarray(ic["r"]), np.asarray(ic["h"]))
            self.state = dist.shard_state(self.distplan, state)
            if self.self_gravity:
                self._plan_dist_tree(np.asarray(self.state.r))
            self._place()
            self._compile()
            self._run_dist(bootstrap=True)
            tries = 0
            while bool(self.state.neib_overflow):
                tries += 1
                if tries > 3:
                    raise RuntimeError("distributed MFV setup keeps "
                                       "overflowing")
                self._replan(growth=1.3)
                self._run_dist(bootstrap=True)
        self._init_output_cadence()

    def _replan(self, growth: float = 1.3):
        sched = getattr(self, "_blocksched", None)
        if self.use_block and sched is not None:
            # per-particle schedule arrays migrate with the particles
            nstep_h = dist.unshard_array(self.distplan, sched.nstep_part,
                                         self._n_orig)
            dtnext_h = dist.unshard_array(self.distplan, sched.dt_next,
                                          self._n_orig)
        host = dist.unshard_state(self.distplan, self.state, self._n_orig)
        alive = np.asarray(host.alive)
        h_np = np.asarray(host.h)[alive]
        self._plan_all(np.asarray(host.r), h_np, growth=growth)
        host = host.replace(neib_overflow=jnp.asarray(False))
        self.state = dist.shard_state(self.distplan, host)
        if self.use_block and sched is not None:
            self._blocksched = sched._replace(
                nstep_part=jnp.asarray(dist.shard_array(
                    self.distplan, nstep_h, 1)),
                dt_next=jnp.asarray(dist.shard_array(
                    self.distplan, dtnext_h, 1e30)))
        if self.self_gravity:
            self._plan_dist_tree(np.asarray(self.state.r))
        self._place()
        self._compile()

    def main_loop_step(self):
        ntb = max(self.params.intparams["ntreebuildstep"], 1)
        if self.Nsteps > 0 and self.Nsteps % ntb == 0:
            with self.timing.block("DECOMPOSE"):
                self._replan()
        self._clamp_dt_to_tend()
        with self.timing.block("MAIN_LOOP"):
            prev = self.state
            prev_sched = getattr(self, "_blocksched", None)
            self._run_dist(bootstrap=False)
            if bool(self.state.neib_overflow):
                with self.timing.block("GRID_REPLAN"):
                    self.state = prev
                    if prev_sched is not None:
                        self._blocksched = prev_sched
                    self._replan(growth=1.5)
                    self._run_dist(bootstrap=False)
                    if bool(self.state.neib_overflow):
                        raise RuntimeError("distributed MFV neighbour "
                                           "overflow persists")
        self.Nsteps += 1
        self.t = float(self.state.t)

    def _state_to_host(self) -> Dict[str, np.ndarray]:
        host = dist.unshard_state(self.distplan, self.state, self._n_orig)
        return {k: np.asarray(getattr(host, k))
                for k in ("r", "v", "a", "m", "h", "rho", "u",
                          "pressure", "sound", "gpot")}


class DistributedMfvRK2Simulation(DistributedMfvSimulation):
    """Heun (RK2) flavour over the sharded runtime (the flux kernels
    branch on MfvConfig.time_scheme, so only the tag differs)."""

    time_scheme = "rk2"
