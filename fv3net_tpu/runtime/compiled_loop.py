"""The coupled time loop as ONE compiled device program.

The reference's per-`dt_atmos` loop (dynamics -> prephysics ->
radiation -> physics -> postphysics,
workflows/prognostic_c48_run/runtime/loop.py:656-683) is host-
orchestrated: every tendency add, NaN fill, Monitor checkpoint and
mass-conserving state set is its own device op, each paying a
dispatch.  The eager `runtime.loop.TimeLoop` remains the
flexible reference-parity path; THIS module is the production path: it
composes the same pure pieces (the dycore's `one_dt`, the GFS physics
suite, the gray/multiband radiation core, the ML model's `pure_fn`,
the MSE-conserving humidity limiter, the NaN-fill + filled-fraction
diagnostics, the mass-conserving humidity/delp update and the Monitor
tendency/storage diagnostics) into a single jitted function over the
state pytree, so a full coupled step is exactly one dispatch.

Per-substep semantics mirror runtime/loop.py:
  - water_vapor_path before dynamics
    (compute_column_integrated_tracers)
  - Monitor(fv3_dynamics) around the dycore step (monitor.py:21-120)
  - gray radiation heating (wrapper.step_radiation)
  - GFS physics suite + Monitor(fv3_physics) (wrapper.apply_physics)
  - ML postphysics: predict -> fillna (+ filled_frac diags,
    loop.py:103-123) -> MSE-conserving limiter
    (steppers/machine_learning.py:67-101) -> add_tendency
    (loop.py:202) -> mass-conserving set (derived_state.py:99-130) ->
    Monitor(python)

Host work per step is limited to: the cos-zenith-angle / solar-constant
astronomy scalars (cheap numpy on [6,n,n]) and the datetime advance.
"""

from __future__ import annotations

import dataclasses as _dc
import datetime
from typing import Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import CP_AIR, GRAV
from ..util.quantity import Quantity
from ..utils.zenith import cos_zenith_angle
from . import names
from .steppers import non_negative_sphum

DIMS_3D = ("tile", "z", "y", "x")
DIMS_2D = ("tile", "y", "x")


def _monitor(diags, label, before_t, before_q, delp_before,
             after_t, after_q, delp_after, dt):
    """Tendency + path-storage diagnostics of one monitored block
    (runtime/monitor.py:21-120), traced in-graph."""
    for v, b, a in (
        (names.TEMP, before_t, after_t),
        (names.SPHUM, before_q, after_q),
    ):
        tend = (a - b) / dt
        diags[f"tendency_of_{v}_due_to_{label}"] = tend
        diags[f"storage_of_{v}_path_due_to_{label}"] = (
            tend * delp_after / GRAV
        ).sum(axis=1)
    diags[f"storage_of_mass_due_to_{label}"] = (
        (delp_after - delp_before) / GRAV
    ).sum(axis=1) / dt
    return diags


def build_compiled_step(mdl, ml_model=None, split: bool = False):
    """Build the fused coupled-step function from an initialized
    wrapper model (`fv3net_tpu.wrapper.get_model()`).

    Returns a pure function
        step(state, phis, tsfc, total_precip, cosz, solcon)
          -> (state', total_precip', precip_rate, diags)
    jitted with the state donated (in-place HBM update).

    split=True additionally returns the three stage functions
    (dynamics / physics / postphysics), each jitted, for per-substep
    timing breakdowns -- the compiled analogue of the reference's
    pace.util.Timer clocks (runtime/loop.py:272,681).
    """
    from ..physics.gfs import gfs_physics_step
    from ..wrapper import pt_from_temperature, temperature_from_pt

    cfg = mdl.config
    dt = cfg.dt_atmos
    ptop = cfg.ptop
    dtype = mdl.dtype
    one_dt = mdl.run_step.one_dt
    gfs_cfg = mdl.gfs_config
    rad = mdl._radiation
    ml_fn = ml_model.pure_fn if ml_model is not None else None
    ml_params = ml_model.params if ml_model is not None else None

    def temperature(st):
        return temperature_from_pt(st.delp, st.pt, st.q[0], ptop)

    # --- stage 1: monitored dynamics -----------------------------------
    def stage_dynamics(state, phis):
        diags = {}
        diags["water_vapor_path"] = (
            state.q[0] * state.delp / GRAV
        ).sum(axis=1)
        t_b = temperature(state)
        q_b = state.q[0]
        delp_b = state.delp
        st = one_dt(state, phis)
        _monitor(
            diags, "fv3_dynamics", t_b, q_b, delp_b,
            temperature(st), st.q[0], st.delp, dt,
        )
        return st, diags

    # --- stage 2: radiation + GFS physics (monitored) ------------------
    def stage_physics(st, tsfc, total_precip, cosz, solcon):
        diags = {}
        temp = temperature(st)
        qv, qc = st.q[0], st.q[1]
        if rad is not None:
            from ..wrapper import pressure_layers

            pe, _ = pressure_layers(st.delp, ptop)
            p_lay = 0.5 * (pe[:, 1:] + pe[:, :-1])
            out = rad._core(
                cosz, p_lay, st.delp, temp, qv, tsfc, solcon
            )
            heating = (
                out["shortwave_heating_rate"]
                + out["longwave_heating_rate"]
            )
            temp = temp + heating * dt
            diags.update(out)
        t_b, q_b = temp, qv
        extra = []  # prognostic hydrometeors beyond (qv, qc)
        if cfg.physics_suite == "gfs":
            prognostic_mp = (
                st.q.shape[0] >= 6
                and gfs_cfg.microphysics_scheme == "gfdl"
            )
            mp_tracers = (
                tuple(st.q[2:6]) if prognostic_mp else None
            )
            pout, pdiags = gfs_physics_step(
                temp, qv, qc, st.u, st.v, st.delp, tsfc,
                jnp.asarray(ptop, dtype), dt, cfg=gfs_cfg,
                mp_tracers=mp_tracers,
            )
            temp = pout["air_temperature"]
            qv = pout["specific_humidity"]
            qc = pout["cloud_water_mixing_ratio"]
            if prognostic_mp:
                extra = [
                    pout["cloud_ice_mixing_ratio"],
                    pout["rain_mixing_ratio"],
                    pout["snow_mixing_ratio"],
                    pout["graupel_mixing_ratio"],
                ]
            else:
                extra = []
            st = st._replace(
                u=pout["u_dgrid"].astype(dtype),
                v=pout["v_dgrid"].astype(dtype),
            )
            precip = pdiags.pop("total_precipitation")
            diags.update(pdiags)
        elif cfg.physics_suite == "simple" and cfg.do_sat_adj:
            from ..physics.simple import saturation_adjustment
            from ..wrapper import pressure_layers

            pe, _ = pressure_layers(st.delp, ptop)
            p_lay = 0.5 * (pe[:, 1:] + pe[:, :-1])
            temp, qv, qc, precip = saturation_adjustment(
                temp, qv, qc, p_lay, st.delp, dt
            )
        else:
            precip = jnp.zeros_like(tsfc)
        _monitor(
            diags, "fv3_physics", t_b, q_b, st.delp,
            temp, qv, st.delp, dt,
        )
        total_precip = total_precip + precip / 1000.0  # kg/m2 -> m
        precip_rate = precip / dt
        q_new = jnp.stack([qv, qc] + extra).astype(dtype)
        if st.q.shape[0] > q_new.shape[0]:
            # tracers beyond the suite's prognostic set (e.g. a
            # 6-tracer state under a 2-condensate scheme) pass through
            # unchanged -- mirror of the eager wrapper path
            q_new = jnp.concatenate(
                [q_new, st.q[q_new.shape[0] :]], axis=0
            )
        st = st._replace(
            pt=pt_from_temperature(st.delp, temp, qv, ptop).astype(
                dtype
            ),
            q=q_new,
        )
        return st, total_precip, precip_rate, diags

    # --- stage 3: ML postphysics (monitored, mass-conserving) ----------
    def _ml_inputs(st, temp, qv):
        """State arrays for every model input name (the eager path
        resolves these through DerivedModelState; the compiled trace
        resolves them here).  Unsupported names fail AT BUILD TIME
        with the name spelled out."""
        available = {
            names.TEMP: lambda: temp,
            names.SPHUM: lambda: qv,
            names.CLOUD: lambda: st.q[1],
            names.DELP: lambda: st.delp,
            names.X_WIND: lambda: st.u,
            names.Y_WIND: lambda: st.v,
        }
        if st.w is not None:
            available["vertical_wind"] = lambda: st.w
        out = {}
        for name in ml_model.input_variables:
            if name == "time":
                continue
            if name not in available:
                raise NotImplementedError(
                    f"compiled TimeLoop cannot supply ML input "
                    f"{name!r}; use the eager TimeLoop for models "
                    f"with derived inputs"
                )
            out[name] = available[name]()
        return out

    def stage_postphysics(st):
        diags = {}
        if ml_fn is None:
            return st, diags
        temp = temperature(st)
        qv, qc = st.q[0], st.q[1]
        preds = ml_fn(ml_params, _ml_inputs(st, temp, qv))
        tend = {}
        for k, v in preds.items():
            if k not in names.TENDENCY_TO_STATE_NAME:
                continue
            isnan = jnp.isnan(v)
            tend[k] = jnp.where(isnan, 0.0, v)
            diags[f"{k}_filled_frac"] = isnan.mean()
        dQ1 = tend.get("dQ1", jnp.zeros_like(temp))
        dQ2 = tend.get("dQ2", jnp.zeros_like(qv))
        dQ1, dQ2 = non_negative_sphum(qv, dQ1, dQ2, dt)
        t2 = temp + dQ1 * dt
        qv2 = qv + dQ2 * dt
        # dry-air-mass-conserving humidity set
        # (wrapper.set_state_mass_conserving semantics)
        delp2 = st.delp * (1.0 - qv) / (1.0 - qv2)
        _monitor(
            diags, "python", temp, qv, st.delp, t2, qv2, delp2, dt
        )
        st = st._replace(
            delp=delp2.astype(dtype),
            pt=pt_from_temperature(delp2, t2, qv2, ptop).astype(
                dtype
            ),
            q=jnp.concatenate(
                [jnp.stack([qv2, qc]), st.q[2:]]
            ).astype(dtype),
        )
        return st, diags

    def full_step(state, phis, tsfc, total_precip, cosz, solcon):
        st, d1 = stage_dynamics(state, phis)
        st, total_precip, precip_rate, d2 = stage_physics(
            st, tsfc, total_precip, cosz, solcon
        )
        st, d3 = stage_postphysics(st)
        diags = {**d1, **d2, **d3}
        return st, total_precip, precip_rate, diags

    fused = jax.jit(full_step, donate_argnums=(0,))
    if not split:
        return fused
    stages = {
        "dynamics": jax.jit(stage_dynamics),
        "physics": jax.jit(stage_physics),
        "postphysics": jax.jit(stage_postphysics),
    }
    return fused, stages


class CompiledTimeLoop:
    """Drop-in TimeLoop with the whole coupled step as one dispatch.

    Iterates (time, diagnostics) pairs like `runtime.loop.TimeLoop`
    (the reference TimeLoop contract, runtime/loop.py:239); the
    diagnostics dict holds device arrays wrapped as Quantities --
    materialization happens only when a sink reads them.
    """

    def __init__(self, wrapper_module, ml_model=None,
                 n_steps: Optional[int] = None):
        self._wm = wrapper_module
        self.mdl = wrapper_module.get_model()
        self.n_steps = n_steps
        self._step_fn = build_compiled_step(self.mdl, ml_model)
        self._step_count = 0
        # constant surface fields staged to the device once -- the
        # per-step host work must stay O(astronomy scalars)
        self._tsfc = jnp.asarray(self.mdl.tsfc, self.mdl.dtype)
        from .timing import Timer

        self.timer = Timer()

    def _astronomy(self):
        """Solar inputs at the END time of the step: the eager loop
        advances the clock inside step_dynamics, so radiation sees
        time + dt_atmos (runtime/loop.py substep order)."""
        mdl = self.mdl
        t_rad = mdl.time + datetime.timedelta(
            seconds=mdl.config.dt_atmos
        )
        np_dtype = np.dtype(jnp.zeros((), mdl.dtype).dtype)
        if mdl._radiation is not None:
            mdl._radiation.radupdate(t_rad)
            solcon = np_dtype.type(mdl._radiation._solcon)
        else:
            solcon = np_dtype.type(0.0)
        cosz = np.maximum(
            cos_zenith_angle(
                t_rad, np.rad2deg(mdl.lon), np.rad2deg(mdl.lat)
            ),
            0.0,
        )
        return cosz.astype(np_dtype), solcon

    def step(self) -> Mapping[str, Quantity]:
        """Advance one dt_atmos; returns the diagnostics mapping."""
        mdl = self.mdl
        cosz, solcon = self._astronomy()
        with self.timer.clock("mainloop"):
            st, total_precip, precip_rate, diags = self._step_fn(
                mdl.state,
                mdl.phis,
                self._tsfc,
                jnp.asarray(mdl.total_precip, mdl.dtype),
                jnp.asarray(cosz),
                jnp.asarray(solcon),
            )
        mdl.state = st
        mdl.total_precip = total_precip
        mdl.precip_rate = precip_rate
        mdl.step_count += 1
        mdl.time = mdl.time + datetime.timedelta(
            seconds=mdl.config.dt_atmos
        )
        self._step_count += 1
        out = {}
        for k, v in diags.items():
            dims = (
                DIMS_3D if getattr(v, "ndim", 0) == 4
                else DIMS_2D if getattr(v, "ndim", 0) == 3
                else ()
            )
            out[k] = Quantity(v, dims, "")
        return out

    def __iter__(self):
        while (
            self.n_steps is None or self._step_count < self.n_steps
        ):
            diags = self.step()
            yield self.mdl.time, diags

    def block(self):
        """Wait until the in-flight step has finished on the device."""
        jax.block_until_ready(self.mdl.state)
