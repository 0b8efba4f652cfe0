"""Multi-chip distributed grad-h SPH simulation controller.

The production analogue of the reference's MPI simulation mode
(SphSimulation + MpiControl: domain decomposition at
src/Mpi/MpiKDTreeDecomposition.cpp:56-280, per-step ghost exchange at
src/Hydrodynamics/Ghosts.cpp:161-202, dt Allreduce at
src/Common/Simulation.cpp:1736-1747, migration at tree rebuilds at
src/Mpi/MpiKDTreeDecomposition.cpp:289).

Selected with the `Nmpi` parameter (> 1): the particle state is sharded
into z-slab blocks over a jax Mesh and the WHOLE step — leapfrog predict,
sharded binning + (multi-ring) ppermute halo hydro, distributed tree
gravity (LET or replicated fallback), replicated sinks/stars with psum'd
star sums and collectively-chosen creation, corrector, pmin timestep —
runs as one shard_map-jitted program.  Re-decomposition (the
migration/load-balance analogue) happens every `ntreebuildstep` steps on
the host.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from ..integrate.leapfrog import correct, predict, sph_timestep
from ..parallel import dist
from ..state import SphState
from .simulation import GradhSphSimulation, Snapshot


class DistributedGradhSphSimulation(GradhSphSimulation):
    """GradhSph controller running SPMD over all local devices."""

    def process_parameters(self):
        super().process_parameters()
        p = self.params
        self.n_shards = p.intparams["Nmpi"]
        self.letplan = None
        n_dev = len(jax.devices())
        if self.n_shards <= 1:
            self.n_shards = n_dev
        if self.n_shards > n_dev:
            raise ValueError(f"Nmpi={self.n_shards} > {n_dev} devices")
        if self.box.mirror_walls() and self.neib_search != "bruteforce":
            # the base class routes mirror x {self-gravity, dust, block,
            # sinks} to the single-chip all-pairs fallback; the SHARDED
            # kernels carry image-cell support for every coupling
            # (parallel/dist._shard_mirror_binning), so re-enable the
            # grid path here
            self.use_celllist = True
        unsupported = []
        if not self.use_celllist:
            unsupported.append("bruteforce neighbour search")
        if unsupported:
            raise NotImplementedError(
                "distributed mode does not yet support: "
                + ", ".join(unsupported))

    # -- planning ----------------------------------------------------------
    def _plan_all(self, r_np: np.ndarray, h_np: np.ndarray,
                  growth: float = 1.3):
        from ..ops.sph_grid27 import plan_grid27

        h_max = float(h_np.max()) * growth
        self.gridspec = plan_grid27(self.box, r_np, h_max,
                                    self.kern.kernrange,
                                    z_multiple=self.n_shards)
        # balance="auto": clustered distributions re-split on
        # count-weighted row boundaries (FindLoadBalancingDivision
        # analogue, parallel/dist._balance_rows)
        self.distplan = dist.plan_decomposition(self.gridspec, r_np,
                                                self.n_shards,
                                                balance="auto")

    def _plan_dist_tree(self, r_sharded: np.ndarray):
        """Plan distributed gravity.  Preferred: the memory-scalable LET
        decomposition (parallel/let.py — per-shard local trees + pruned
        interior summaries + ring halo bands, the analogue of the
        reference's pruned trees, HydroTree.cpp:1044-1238), including
        Ewald (true-periodic) mode: the combined ring walk min-images +
        Ewald-corrects every interaction and the far-shard summary walk
        min-images its MAC and corrects accepted cells.  Fallback when
        the geometry can't support it (tiny slabs / S < 2): the
        replicated all_gather path below."""
        from ..parallel import let as let_mod

        p = self.params
        mp = p.stringparams["multipole"]
        theta_sqd = p.floatparams["thetamaxsqd"]
        h_max = float(np.asarray(self.state.h).max()) \
            if self.state is not None else 0.0
        prev_let = getattr(self, "letplan", None)
        cell0 = self.gridspec.extents[0] / self.gridspec.ncells[0]
        w_min = (float(self.distplan.row_len.min()) * cell0
                 if self.distplan.balanced else None)
        self.letplan = let_mod.plan_let(
            np.asarray(r_sharded, np.float64), self.distplan.perm,
            self.n_shards, self.distplan.cap,
            z_lo=self.gridspec.lo[0], z_extent=self.gridspec.extents[0],
            leaf_size=32, theta_sqd=theta_sqd,
            quadrupole=mp in ("quadrupole", "fast_quadrupole"),
            h_support=self.kern.kernrange * h_max, prev=prev_let,
            w_slab_min=w_min)
        if self.letplan is not None:
            self.treespec = None
            self.state = self.state.replace(
                bucket_map=jnp.asarray(self.letplan.gmap))
            return
        self._plan_replicated_tree(r_sharded, mp, theta_sqd)

    def _plan_replicated_tree(self, r_sharded, mp, theta_sqd):
        """Bucket plan over the REAL slots of the sharded layout only;
        bucket entries are then remapped to sharded-slot indices.  (Pads
        must not enter the KD planner: a far-sentinel pad cluster hijacks
        the longest-axis choice and produces domain-spanning slab buckets
        that break the min-image unwrap.)"""
        from ..ops.tree import plan_buckets_kd, plan_tree_for_buckets
        real_idx = np.nonzero(self.distplan.perm >= 0)[0]
        L = 32
        gmap_r = plan_buckets_kd(np.asarray(r_sharded, np.float64)
                                 [real_idx], leaf_size=L)
        gmap = np.where(gmap_r >= 0,
                        real_idx[np.maximum(gmap_r, 0)],
                        -1).astype(np.int32)
        # pad group count to a shard multiple so every shard walks an
        # equal contiguous range
        G = gmap.shape[0]
        if G % self.n_shards != 0:
            G2 = -(-G // self.n_shards) * self.n_shards
            gmap = np.concatenate(
                [gmap, np.full((G2 - G, L), -1, np.int32)])
        near_cap = int(13.0 * L * (0.1 / max(theta_sqd, 1e-3)) ** 1.5) + 48
        old = self.treespec
        if old is not None and near_cap < old.near_cap <= 4 * near_cap:
            near_cap = old.near_cap
        self.treespec = plan_tree_for_buckets(
            gmap, theta_sqd=theta_sqd,
            quadrupole=mp in ("quadrupole", "fast_quadrupole"),
            fast=mp.startswith("fast"), near_cap=near_cap,
            frontier=2 * near_cap + 64)
        self.state = self.state.replace(bucket_map=jnp.asarray(gmap))

    # -- jitted step -------------------------------------------------------
    def _sharded_lead_dims(self):
        dims = {self.state.N}
        if getattr(self, "letplan", None) is not None:
            dims.add(self.letplan.gmap.shape[0])   # per-shard bucket maps
        return dims

    def _dist_specs(self):
        dims = self._sharded_lead_dims()

        def rule(x):
            if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] in dims:
                return P("dp", *([None] * (x.ndim - 1)))
            return P()

        return jax.tree_util.tree_map(rule, self.state)

    def _dist_force_pass(self, s: SphState, sinks, alive):
        """Shard-local hydro + distributed gravity + (replicated) sink
        coupling.  Runs INSIDE shard_map; sinks are replicated, so star
        sums over local gas are psum'd (reference star-gas Allreduce,
        src/Mpi/MpiControl.cpp:365-381)."""
        box, sim = self.box, self
        plan = self.distplan
        if getattr(sim, "scheme", "gradh") == "sm2012":
            s = dist.dist_sm2012_pass(
                self.mesh, plan, sim.kern, sim.visc, sim.gamma, box,
                sim.h_fac, sim.h_converge, sim.hydro_forces, s, alive)
        elif getattr(sim, "has_dust", False):
            # two TYPE-MASKED passes, the single-chip split
            # (simulation.py _hydro_only_pass): gas density/EOS/forces
            # from gas sources; dust gets h from dust neighbours only
            from ..state import DUST_TYPE

            is_dust = s.ptype == DUST_TYPE
            s_g = dist.dist_hydro_pass(
                self.mesh, plan, sim.kern, sim.visc, box, sim.eos,
                sim.h_fac, sim.h_converge, sim.hydro_forces, s,
                alive & ~is_dust)
            s_d = dist.dist_hydro_pass(
                self.mesh, plan, sim.kern, sim.visc, box, sim.eos,
                sim.h_fac, sim.h_converge, False, s, alive & is_dust)
            pick = lambda g, d: jnp.where(is_dust, d, g)
            z = jnp.zeros_like(s.u)
            s = s.replace(
                h=pick(s_g.h, s_d.h), rho=pick(s_g.rho, s_d.rho),
                invomega=pick(s_g.invomega, s_d.invomega),
                zeta=pick(s_g.zeta, s_d.zeta),
                hfactor=pick(s_g.hfactor, s_d.hfactor),
                u=pick(s_g.u, z), pressure=pick(s_g.pressure, z),
                sound=pick(s_g.sound, z),
                a=jnp.where(is_dust[:, None], 0.0, s_g.a),
                dudt=pick(s_g.dudt, z), div_v=pick(s_g.div_v, z),
                neib_overflow=s_g.neib_overflow | s_d.neib_overflow)
        else:
            s = dist.dist_hydro_pass(
                self.mesh, plan, sim.kern, sim.visc, box, sim.eos,
                sim.h_fac, sim.h_converge, sim.hydro_forces, s, alive)
        if sim.self_gravity:
            pdims = box.periodic_dims()
            pext = [box.size[k] if k in pdims else 0.0
                    for k in range(s.ndim)] if pdims else None
            m_grav = sim._gravity_mass(s)
            if sim.letplan is not None:
                from ..parallel.let import let_gravity

                a_g, gpot, ovg = let_gravity(
                    sim.letplan, s.bucket_map, s.r, m_grav, s.h,
                    s.zeta * s.hfactor, alive, sim.kern,
                    periodic_extent=pext,
                    ewald_table=sim.ewald_table if sim.use_ewald
                    else None)
            else:
                a_g, gpot, ovg = dist.dist_tree_gravity(
                    sim.treespec, s.bucket_map, s.replace(m=m_grav),
                    sim.kern, alive, plan.n_shards,
                    periodic_extent=pext,
                    ewald_table=sim.ewald_table if sim.use_ewald
                    else None)
            s = s.replace(a=s.a + a_g, gpot=gpot,
                          neib_overflow=s.neib_overflow | ovg)
        if sim.extpot != "none":
            from ..ops.gravity import external_potential

            a_x, _, pot_x = external_potential(
                sim.extpot, sim.extpot_cfg, s.r, s.v)
            s = s.replace(a=s.a + a_x, gpot=s.gpot + pot_x)
        if sinks is not None:
            from ..ops.gravity import direct_softened
            from ..ops.sph_gravity import star_gas_forces

            m_live = jnp.where(alive, s.m, 0.0)
            m_star = jnp.where(sinks.active, sinks.m, 0.0)
            a_gs, gp_gs, a_st, gp_st = star_gas_forces(
                sim.kern, s.r, m_live, s.h, sinks.r, m_star, sinks.h,
                sinks.active)
            # gas->star sums span all shards' local gas
            a_st = lax.psum(a_st, "dp")
            ss = direct_softened(sinks.r, sinks.v, m_star, sinks.h,
                                 sim.kern)
            a_star_tot = a_st + ss.a
            if sim.extpot != "none":
                a_x, _, _ = external_potential(
                    sim.extpot, sim.extpot_cfg, sinks.r, sinks.v)
                a_star_tot = a_star_tot + a_x
            sinks = sinks._replace(
                a=jnp.where(sinks.active[:, None], a_star_tot, 0.0))
            s = s.replace(
                a=jnp.where(alive[:, None], s.a + a_gs, 0.0),
                dudt=jnp.where(alive, s.dudt, 0.0),
                gpot=s.gpot + jnp.where(alive, gp_gs, 0.0))
        return s, sinks

    def _dist_apply_drag(self, s: SphState, dt, alive):
        """Sharded analogue of SimulationBase._apply_drag: dense-shift
        drag kernels with halo ghosts (runs INSIDE shard_map)."""
        from ..state import DUST_TYPE

        tp = self.dust_forces == "test_particle"
        d = dist.dist_drag_pass(self.distplan, self.kern, self.drag_law,
                                self.box, dt, s, alive, tp)
        is_dust = s.ptype == DUST_TYPE
        return s.replace(
            a=s.a + d.a_drag, dudt=s.dudt + d.dudt,
            sound=jnp.where(is_dust, d.sound, s.sound),
            div_v=jnp.where(is_dust, d.div_v, s.div_v))

    def _dist_td_avisc(self, s: SphState, alive):
        """Sharded analogue of SimulationBase._td_avisc (runs INSIDE
        shard_map): cd2010 raises alpha instantly via the dense halo
        pass; mm97 evolves it pointwise."""
        if not self.integ.td_avisc:
            return s, jnp.zeros_like(s.alpha)
        if self.td_avisc_type == "cd2010":
            alpha_new, dal = dist.dist_cd2010_pass(
                self.distplan, self.kern, self.visc, self.box, s, alive)
            return s.replace(alpha=alpha_new), dal
        return s, self._dalphadt(s)

    def _dist_dt(self, s: SphState, sinks, alive):
        dt_part = jnp.where(alive,
                            sph_timestep(self.integ, s, self.hydro_forces),
                            1e30)
        dt_next = lax.pmin(jnp.min(dt_part), "dp")
        if sinks is not None:
            amag = jnp.sqrt(jnp.sum(sinks.a * sinks.a, axis=-1))
            dt_sink = self.integ.accel_mult * jnp.sqrt(
                sinks.h / (amag + 1e-30))
            dt_sink = jnp.where(sinks.active, dt_sink, 1e30)
            dt_next = jnp.minimum(dt_next, jnp.min(dt_sink))
        return dt_next

    def _sched_specs(self):
        """PartitionSpecs for the BlockSchedule carry: per-particle arrays
        (nstep_part, dt_next) shard with the particles; the scalar ladder
        bookkeeping is replicated (every shard computes it identically via
        the collective reductions inside init_schedule/end_timestep)."""
        from ..integrate.block import BlockSchedule

        return BlockSchedule(n=P(), level_max=P(), nresync=P(),
                             dt_base=P(), dt_max=P(),
                             nstep_part=P("dp"), dt_next=P("dp"))

    def _dist_sink_create_accrete(self, s: SphState, sinks, alive):
        """Collective sink creation + accretion (shared by the global-dt
        and block-tick sink steps; runs INSIDE shard_map).  Creation picks
        the global best candidate via all_gather; accretion psums the
        per-shard mass/momentum sums (reference MPI sink sync,
        MpiControl::UpdateSinksAfterAccretion, MpiControl.cpp:408-431).
        Returns (state, sinks, alive)."""
        from ..ops.sinks import (accretion_sums, apply_accretion,
                                 apply_sink_creation, sink_candidate)

        cfg = self.sink_cfg
        if cfg.create:
            cand, gi = sink_candidate(cfg, s.r, s.v, s.m, s.h,
                                      s.rho, alive)
            cands = lax.all_gather(cand, "dp")     # (S, row)
            win = jnp.argmax(cands[:, -1])
            sinks, created = apply_sink_creation(sinks, cands[win],
                                                 s.r.shape[1])
            my_idx = lax.axis_index("dp")
            kill = created & (win == my_idx)
            alive = alive.at[gi].set(jnp.where(kill, False, alive[gi]))
        if cfg.accrete:
            dm, dmom, dmr, eaten = accretion_sums(
                cfg, sinks, s.r, s.v, s.m, alive)
            dm = lax.psum(dm, "dp")
            dmom = lax.psum(dmom, "dp")
            dmr = lax.psum(dmr, "dp")
            sinks = apply_accretion(sinks, dm, dmom, dmr)
            alive = alive & ~eaten
        s = self._kill_eaten(s, alive)
        return s, sinks, alive

    def _build_dist_block(self, bootstrap: bool):
        """Hierarchical block timesteps over the sharded runtime (the
        reference runs ComputeBlockTimesteps under MPI as a matter of
        course, Simulation.cpp:1763-2197 + dt Allreduce :1736-1747).
        Per-particle levels shard trivially; the scalar ladder reductions
        (dt_min, occupied level_max) are pmin/pmax inside the tick.  The
        tick is the full-pass variant (every particle's forces refreshed
        each tick, like the single-chip bruteforce block tick) — the
        active-compacted host-driven path is single-chip-only."""
        from ..integrate.block import (BlockConfig, advance,
                                       check_timesteps, end_timestep,
                                       init_schedule)

        integ, box = self.integ, self.box
        sim = self
        cfg = BlockConfig(nlevels=self.nlevels,
                          level_diff_max=self.level_diff_max)
        u_mode = "radws" if self.use_radws_energy else (
            "energy" if integ.energy_integration else "none")

        def local_gas_block(s: SphState):
            alive = s.alive
            s, _ = self._dist_force_pass(s, None, alive)
            if sim.has_dust:
                s = self._dist_apply_drag(
                    s, jnp.asarray(0.0, s.r.dtype), alive)
            if sim.use_radws_energy:
                s = self._radws_equilibrium(s)
            s = s.replace(a0=s.a, dudt0=s.dudt, u0=s.u, r0=s.r, v0=s.v)
            dt_part = sph_timestep(integ, s, self.hydro_forces)
            s, sched = init_schedule(cfg, s, dt_part, axis_name="dp")
            return s.replace(dt=sched.dt_base), sched

        def local_gas_tick(s: SphState, B):
            s, active, t = advance(s, B, u_mode)
            r = box.wrap(s.r)
            r, v = box.reflect(r, s.v)
            s = s.replace(r=r, v=v, r0=box.wrap(s.r0), t=t)
            alive = s.alive
            s, _ = self._dist_force_pass(s, None, alive)
            if sim.has_dust:
                # per-particle step dt (Dust.cpp:216-218 drag_timestep)
                dt_drag = B.nstep_part.astype(s.m.dtype) * B.dt_base
                s = self._dist_apply_drag(s, dt_drag, alive)
            s = s.replace(levelneib=dist.dist_levelneib_pass(
                self.distplan, sim.kern, box, s, alive))
            if integ.td_avisc:
                s = s.replace(alpha=s.alpha
                              + self._dalphadt(s) * B.dt_base)
            active, nstep_p, level = check_timesteps(cfg, s, B, active)
            if sim.use_radws_energy:
                # refresh (ueq, dt_therm) for particles ending their step
                # (EnergyRadws::EndTimestep) — pointwise, shard-safe
                s2 = self._radws_equilibrium(s)
                s = s.replace(
                    ueq=jnp.where(active, s2.ueq, s.ueq),
                    dt_therm=jnp.where(active, s2.dt_therm, s.dt_therm))
            dt_crit = sph_timestep(integ, s, self.hydro_forces)
            s, B = end_timestep(cfg, s, B, active, level, nstep_p,
                                dt_crit, t, u_mode, axis_name="dp")
            return s.replace(nstep=s.nstep + 1), B

        def local_sinks_block(s: SphState, sinks):
            alive = s.alive
            s, sinks = self._dist_force_pass(s, sinks, alive)
            s = s.replace(a0=s.a, dudt0=s.dudt, u0=s.u, r0=s.r, v0=s.v)
            sinks = sinks._replace(a0=sinks.a, r0=sinks.r, v0=sinks.v)
            dt_part = sph_timestep(integ, s, self.hydro_forces)
            s, sched = init_schedule(
                cfg, s, dt_part, dt_extra=self._sink_timestep(sinks),
                axis_name="dp")
            return s.replace(dt=sched.dt_base), sinks, sched

        def local_sinks_tick(s: SphState, sinks, B):
            s, active, t = advance(s, B, u_mode)
            dtb = B.dt_base
            # sinks ALWAYS step at dt_base (the reference forces N-body
            # levels >= hydro level_max, Simulation.cpp:1860-1873)
            sinks = sinks._replace(
                r=sinks.r0 + sinks.v0 * dtb + 0.5 * sinks.a0 * dtb * dtb,
                v=sinks.v0 + sinks.a0 * dtb)
            r = box.wrap(s.r)
            r, v = box.reflect(r, s.v)
            s = s.replace(r=r, v=v, r0=box.wrap(s.r0), t=t)
            alive = s.alive
            s, sinks = self._dist_force_pass(s, sinks, alive)
            s = s.replace(levelneib=dist.dist_levelneib_pass(
                self.distplan, sim.kern, box, s, alive))
            if integ.td_avisc:
                s = s.replace(alpha=s.alpha + self._dalphadt(s) * dtb)
            active, nstep_p, level = check_timesteps(cfg, s, B, active)
            dt_crit = sph_timestep(integ, s, self.hydro_forces)
            v_c = sinks.v + 0.5 * dtb * (sinks.a - sinks.a0)
            sinks = sinks._replace(v=v_c, r0=sinks.r, v0=v_c, a0=sinks.a)
            s, sinks, alive = self._dist_sink_create_accrete(s, sinks,
                                                             alive)
            s, B = end_timestep(cfg, s, B, active, level, nstep_p,
                                dt_crit, t, u_mode,
                                dt_extra=self._sink_timestep(sinks),
                                axis_name="dp")
            return s.replace(nstep=s.nstep + 1), sinks, B

        specs = self._dist_specs()
        sspecs = self._sched_specs()
        if getattr(self, "has_sinks", False):
            sink_specs = jax.tree_util.tree_map(lambda x: P(), self.sinks)
            if bootstrap:
                fn, in_specs = local_sinks_block, (specs, sink_specs)
                out_specs = (specs, sink_specs, sspecs)
            else:
                fn = local_sinks_tick
                in_specs = (specs, sink_specs, sspecs)
                out_specs = (specs, sink_specs, sspecs)
        elif bootstrap:
            fn, in_specs, out_specs = (local_gas_block, (specs,),
                                       (specs, sspecs))
        else:
            fn, in_specs, out_specs = (local_gas_tick, (specs, sspecs),
                                       (specs, sspecs))
        sm = shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
        return jax.jit(sm)

    def _build_dist_step(self, bootstrap: bool):
        integ, box = self.integ, self.box
        sim = self

        def local_gas(s: SphState) -> SphState:
            dt = s.dt
            if not bootstrap:
                t = s.t + dt
                s = predict(integ, s, dt)
                if sim.use_radws_energy:
                    # exponential relaxation toward radiative equilibrium
                    # (EnergyRadws::EnergyIntegration) — pointwise, so it
                    # shards trivially
                    from ..ops.radws import radws_energy_integration

                    s = s.replace(u=radws_energy_integration(
                        s.u0, s.ueq, s.dt_therm, dt))
                r = box.wrap(s.r)
                r, v = box.reflect(r, s.v)
                s = s.replace(r=r, v=v, r0=box.wrap(s.r0))
            alive = s.alive
            s, _ = self._dist_force_pass(s, None, alive)
            if sim.has_dust:
                dt_drag = jnp.asarray(0.0, s.r.dtype) if bootstrap else dt
                s = self._dist_apply_drag(s, dt_drag, alive)
            if bootstrap:
                s = s.replace(a0=s.a, dudt0=s.dudt, u0=s.u, r0=s.r,
                              v0=s.v)
                if sim.use_radws_energy:
                    s = self._radws_equilibrium(s)
            else:
                s, dal = self._dist_td_avisc(s, alive)
                s = correct(integ, s, dt, dal)
                if sim.use_radws_energy:
                    s = self._radws_equilibrium(s)
                    s = s.replace(u0=s.u, dudt0=s.dudt)
            dt_next = self._dist_dt(s, None, alive)
            if bootstrap:
                return s.replace(dt=dt_next)
            return s.replace(t=t, dt=dt_next, nstep=s.nstep + 1)

        def local_sinks(s: SphState, sinks):
            from ..ops.sinks import (accretion_sums, apply_accretion,
                                     apply_sink_creation, sink_candidate)

            dt = s.dt
            if not bootstrap:
                t = s.t + dt
                s = predict(integ, s, dt)
                sinks = sinks._replace(
                    r=sinks.r0 + sinks.v0 * dt + 0.5 * sinks.a0 * dt * dt,
                    v=sinks.v0 + sinks.a0 * dt)
                r = box.wrap(s.r)
                r, v = box.reflect(r, s.v)
                s = s.replace(r=r, v=v, r0=box.wrap(s.r0))
            alive = s.alive
            s, sinks = self._dist_force_pass(s, sinks, alive)
            if sim.has_dust:
                dt_drag = jnp.asarray(0.0, s.r.dtype) if bootstrap else dt
                s = self._dist_apply_drag(s, dt_drag, alive)
            if bootstrap:
                s = s.replace(a0=s.a, dudt0=s.dudt, u0=s.u, r0=s.r,
                              v0=s.v)
                sinks = sinks._replace(a0=sinks.a, r0=sinks.r, v0=sinks.v)
                return (s.replace(dt=self._dist_dt(s, sinks, alive)),
                        sinks)
            s, dal = self._dist_td_avisc(s, alive)
            s = correct(integ, s, dt, dal)
            v_c = sinks.v + 0.5 * dt * (sinks.a - sinks.a0)
            sinks = sinks._replace(v=v_c, r0=sinks.r, v0=v_c, a0=sinks.a)
            cfg = sim.sink_cfg
            if cfg.create:
                # global best candidate: gather every shard's local best
                # and apply the winner identically on all shards
                cand, gi = sink_candidate(cfg, s.r, s.v, s.m, s.h,
                                          s.rho, alive)
                cands = lax.all_gather(cand, "dp")     # (S, row)
                win = jnp.argmax(cands[:, -1])
                sinks, created = apply_sink_creation(sinks, cands[win],
                                                     s.r.shape[1])
                my_idx = lax.axis_index("dp")
                kill = created & (win == my_idx)
                alive = alive.at[gi].set(jnp.where(kill, False,
                                                   alive[gi]))
            if cfg.accrete:
                dm, dmom, dmr, eaten = accretion_sums(
                    cfg, sinks, s.r, s.v, s.m, alive)
                dm = lax.psum(dm, "dp")
                dmom = lax.psum(dmom, "dp")
                dmr = lax.psum(dmr, "dp")
                sinks = apply_accretion(sinks, dm, dmom, dmr)
                alive = alive & ~eaten
            s = self._kill_eaten(s, alive)
            dt_next = self._dist_dt(s, sinks, alive)
            return (s.replace(t=t, dt=dt_next, nstep=s.nstep + 1), sinks)

        specs = self._dist_specs()
        if getattr(self, "has_sinks", False):
            sink_specs = jax.tree_util.tree_map(lambda x: P(), self.sinks)
            fn, in_specs, out_specs = (local_sinks, (specs, sink_specs),
                                       (specs, sink_specs))
        else:
            fn, in_specs, out_specs = local_gas, (specs,), specs
        sm = shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
        return jax.jit(sm)

    def _compile(self):
        self.n_recompiles = getattr(self, "n_recompiles", 0) + 1
        build = self._build_dist_block if self.use_block \
            else self._build_dist_step
        self._step_fn = build(bootstrap=False)
        self._bootstrap_fn = build(bootstrap=True)
        self._migrate_fn = None     # plan changed; rebuild lazily

    # -- device-side migration ----------------------------------------------
    def _build_migrate(self):
        """Jitted device-side re-decomposition (the reference's Alltoallv
        particle exchange, src/Mpi/MpiControl.cpp:1073-1150
        SendReceiveParticles): one lax.all_to_all inside shard_map moves
        z-slab crossers to their owner shard — no host round-trip."""
        plan = self.distplan
        specs = self._dist_specs()
        with_sched = self.use_block

        def fn(s, *extra):
            s2, ex2, over = dist.migrate_particles(plan, s, extra)
            over = lax.pmax(over.astype(jnp.int32), "dp") > 0
            return (s2,) + tuple(ex2) + (over,)

        ex_specs = (P("dp"), P("dp")) if with_sched else ()
        in_specs = (specs,) + ex_specs
        out_specs = (specs,) + ex_specs + (P(),)
        sm = shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
        return jax.jit(sm)

    def _try_device_migrate(self) -> bool:
        """Device-side migration at the rebuild cadence.  Falls back to
        the host replan when (a) self-gravity plans (LET gmap /
        replicated-tree bucket_map) reference the current slot layout,
        (b) the fixed migration capacity overflowed, or (c) it is time
        for the periodic full load re-balance (count-based cap resize,
        every 8th cadence)."""
        if self.self_gravity:
            return False
        self._mig_round = getattr(self, "_mig_round", 0) + 1
        if self._mig_round % 8 == 0:
            return False
        if self._migrate_fn is None:
            self._migrate_fn = self._build_migrate()
        if self.use_block and getattr(self, "_blocksched", None) \
                is not None:
            B = self._blocksched
            s2, nstep_p, dt_n, over = self._migrate_fn(
                self.state, B.nstep_part, B.dt_next)
            if bool(over):
                return False
            self.state = s2
            self._blocksched = B._replace(nstep_part=nstep_p,
                                          dt_next=dt_n)
        else:
            s2, over = self._migrate_fn(self.state)
            if bool(over):
                return False
            self.state = s2
        self._perm_stale = True
        self._mig_used = getattr(self, "_mig_used", 0) + 1
        return True

    def _refresh_perm(self):
        """Rebuild plan.perm from the device iorig after device-side
        migrations (lazy: only when the host needs original order)."""
        if getattr(self, "_perm_stale", False):
            self.distplan = dist.perm_from_iorig(self.distplan,
                                                 self.state.iorig)
            self._perm_stale = False

    # -- host lifecycle ----------------------------------------------------
    def SetupSimulation(self):
        from ..state import make_sph_state

        with self.timing.block("SETUP"):
            self.process_parameters()
            self.mesh = dist.make_mesh(self.n_shards)
            ic = self._initial_conditions()
            state = make_sph_state(ic["r"], ic["v"], ic["m"], ic["h"],
                                   ic["u"])
            if "ptype" in ic:
                state = state.replace(
                    ptype=jnp.asarray(np.asarray(ic["ptype"], np.int32)))
            # initial artificial-viscosity alpha (SphSimulation.cpp:
            # 252-257 — same init as the single-chip setup)
            alpha0 = (self.visc.alpha_visc_min if self.integ.td_avisc
                      else self.visc.alpha_visc)
            state = state.replace(
                alpha=jnp.full_like(state.alpha, alpha0))
            self._n_orig = state.N
            # sinks/stars: replicated on every shard (they are few); the
            # collective pieces live in the jitted step
            from ..ops.sinks import empty_sinks, make_sinks

            self.sinks = None
            nfix = self.params.intparams["Nsinkfixed"]
            n_extra = (nfix if nfix > 0 else 16) if self.create_sinks else 0
            if "star" in ic:
                st = ic["star"]
                self.sinks = make_sinks(st["r"], st["v"], st["m"], st["h"],
                                        n_extra=n_extra)
            elif self.create_sinks:
                self.sinks = empty_sinks(n_extra, self.ndim,
                                         state.r.dtype)
            self.has_sinks = self.sinks is not None
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
                    raise RuntimeError("distributed setup keeps "
                                       "overflowing")
                self._replan(growth=1.3)
                self._run_dist(bootstrap=True)
        self._init_output_cadence()

    def _run_dist(self, bootstrap: bool):
        fn = self._bootstrap_fn if bootstrap else self._step_fn
        if self.use_block:
            if bootstrap:
                if self.has_sinks:
                    self.state, self.sinks, self._blocksched = \
                        fn(self.state, self.sinks)
                else:
                    self.state, self._blocksched = fn(self.state)
            elif self.has_sinks:
                self.state, self.sinks, self._blocksched = \
                    fn(self.state, self.sinks, self._blocksched)
            else:
                self.state, self._blocksched = fn(self.state,
                                                  self._blocksched)
        elif self.has_sinks:
            self.state, self.sinks = fn(self.state, self.sinks)
        else:
            self.state = fn(self.state)

    def _place(self):
        from jax.sharding import NamedSharding

        shardings = dist.state_shardings(self.mesh, self.state,
                                         self._sharded_lead_dims())
        self.state = jax.tree_util.tree_map(
            lambda x, sh: jax.device_put(x, sh), self.state, shardings)
        sched = getattr(self, "_blocksched", None)
        if self.use_block and sched is not None:
            self._blocksched = jax.tree_util.tree_map(
                lambda x, sp: jax.device_put(
                    x, NamedSharding(self.mesh, sp)),
                sched, self._sched_specs())

    def _replan(self, growth: float = 1.3, grow_caps: bool = False):
        """Gather, re-decompose (migration + load balance), re-shard."""
        from ..parallel.let import grow_let_caps

        self._refresh_perm()
        sched = getattr(self, "_blocksched", None)
        if self.use_block and sched is not None:
            # per-particle schedule arrays migrate with the particles
            nstep_h = dist.unshard_array(self.distplan, sched.nstep_part,
                                         self._n_orig)
            dtnext_h = dist.unshard_array(self.distplan, sched.dt_next,
                                          self._n_orig)
        host = dist.unshard_state(self.distplan, self.state, self._n_orig)
        alive = np.asarray(host.alive)
        r_np = np.asarray(host.r)[alive]
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
            if grow_caps and self.letplan is not None:
                self.letplan = grow_let_caps(self.letplan)
            self._plan_dist_tree(np.asarray(self.state.r))
        self._place()
        self._compile()

    def main_loop_step(self):
        ntb = max(self.params.intparams["ntreebuildstep"], 1)
        if self.Nsteps > 0 and self.Nsteps % ntb == 0:
            with self.timing.block("DECOMPOSE"):
                if not self._try_device_migrate():
                    self._replan()
        with self.timing.block("MAIN_LOOP"):
            prev = self.state
            prev_sinks = self.sinks
            prev_sched = getattr(self, "_blocksched", None)
            self._run_dist(bootstrap=False)
            if bool(self.state.neib_overflow):
                with self.timing.block("GRID_REPLAN"):
                    self.state = prev
                    self.sinks = prev_sinks
                    if prev_sched is not None:
                        self._blocksched = prev_sched
                    self._replan(growth=1.3, grow_caps=True)
                    self._run_dist(bootstrap=False)
        self.Nsteps += 1
        self.t = float(self.state.t)

    def _state_to_host(self):
        self._refresh_perm()
        host = dist.unshard_state(self.distplan, self.state, self._n_orig)
        out = {k: np.asarray(getattr(host, k))
               for k in ("r", "v", "a", "m", "h", "rho", "u", "dudt",
                         "pressure", "sound", "div_v", "gpot")}
        if getattr(self, "has_sinks", False):
            out["alive"] = np.asarray(host.alive)
            act = np.asarray(self.sinks.active)
            out["star"] = {k: np.asarray(getattr(self.sinks, k))[act]
                           for k in ("r", "v", "a", "m", "h")}
        return out


class DistributedSM2012Simulation(DistributedGradhSphSimulation):
    """Saitoh-Makino (2012) SPH over the sharded z-slab runtime: the
    dense 27-shift q/force kernels (ops/sm2012.sm2012_pass_dense) run
    shard-local with ppermute halos (the reference's MPI mode covers all
    SPH flavours, src/SM2013/SM2012SphSimulation.cpp + MpiControl)."""

    scheme = "sm2012"

    def process_parameters(self):
        super().process_parameters()
        self.gamma = self.params.floatparams["gamma_eos"]
        if self.params.stringparams["gas_eos"] not in ("energy_eqn",
                                                       "isothermal"):
            raise ValueError("sm2012sph supports energy_eqn/isothermal "
                             "only")
