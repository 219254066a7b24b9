"""Coupling-runtime tests: wrapper API, TimeLoop substeps, steppers,
monitor diagnostics, metrics -- mirroring the reference's MockFV3GFS
pattern (tests/test_derived_state.py:11-63) but against the REAL
JAX model at tiny resolution."""

import datetime

import numpy as np
import pytest

from fv3net_tpu import wrapper
from fv3net_tpu.runtime import names
from fv3net_tpu.runtime.derived_state import DerivedModelState, MergedState
from fv3net_tpu.runtime.loop import TimeLoop, Monitor, add_tendency
from fv3net_tpu.runtime.metrics import compute_metrics, log_metrics
from fv3net_tpu.runtime.steppers import (
    CombinedStepper,
    MachineLearningConfig,
    MultiModelAdapter,
    PureMLStepper,
    PureNudger,
    NudgingConfig,
    Prescriber,
    PrescriberConfig,
    RenamingAdapter,
    non_negative_sphum,
)
from fv3net_tpu.util.quantity import Quantity


@pytest.fixture(scope="module")
def model():
    cfg = wrapper.ModelConfig(
        npx=7, npz=8, dt_atmos=600.0, n_split=4, dtype="float64"
    )
    wrapper.initialize(cfg)
    return wrapper.get_model()


def test_wrapper_state_roundtrip(model):
    st = wrapper.get_state([names.TEMP, names.DELP, names.SPHUM])
    assert st[names.TEMP].dims == ("tile", "z", "y", "x")
    t0 = st[names.TEMP].values.copy()
    wrapper.set_state({names.TEMP: st[names.TEMP].with_data(t0 + 1.0)})
    t1 = wrapper.get_state([names.TEMP])[names.TEMP].values
    np.testing.assert_allclose(t1, t0 + 1.0, rtol=1e-10)
    wrapper.set_state({names.TEMP: st[names.TEMP].with_data(t0)})


def test_wrapper_mass_conserving_humidity_set(model):
    st = wrapper.get_state([names.SPHUM, names.DELP])
    q0 = st[names.SPHUM].values
    dp0 = st[names.DELP].values
    dry0 = (dp0 * (1 - q0)).sum()
    qn = q0 + 1e-4
    wrapper.set_state_mass_conserving(
        {names.SPHUM: st[names.SPHUM].with_data(qn)}
    )
    st2 = wrapper.get_state([names.SPHUM, names.DELP])
    dry1 = (st2[names.DELP].values * (1 - st2[names.SPHUM].values)).sum()
    np.testing.assert_allclose(dry1, dry0, rtol=1e-10)


def test_wrapper_agrid_to_dgrid_transform(model):
    n, nz = model.n, model.nz
    ua = Quantity(np.ones((6, nz, n, n)), ("tile", "z", "y", "x"), "m/s")
    va = Quantity(np.zeros((6, nz, n, n)), ("tile", "z", "y", "x"), "m/s")
    du, dv = wrapper.transform_agrid_winds_to_dgrid_winds(ua, va)
    assert du.data.shape == (6, nz, n + 1, n)
    assert dv.data.shape == (6, nz, n, n + 1)
    # an eastward unit vector has bounded covariant components
    assert np.abs(du.values).max() <= 1.0 + 1e-6
    # round-trip: project to D grid, reconstruct A grid; away from the
    # poles (where 'eastward' degenerates) the flow comes back
    wrapper.set_state(
        {
            names.X_WIND: du,
            names.Y_WIND: dv,
        }
    )
    ua2, va2 = model._agrid_winds()
    ok = np.abs(model.lat) < 1.0
    sel = np.broadcast_to(ok[:, None], ua2.shape)
    # mean error small; pointwise bounded (cube-corner cells carry the
    # round-1 orthogonal-metric approximation error)
    assert np.abs(ua2[sel] - 1.0).mean() < 0.05
    assert np.abs(va2[sel]).mean() < 0.12
    np.testing.assert_allclose(ua2[sel], 1.0, atol=0.45)
    np.testing.assert_allclose(va2[sel], 0.0, atol=0.45)
    wrapper.set_state(
        {
            names.X_WIND: du.with_data(np.zeros_like(du.values)),
            names.Y_WIND: dv.with_data(np.zeros_like(dv.values)),
        }
    )


def test_tracer_metadata(model):
    md = wrapper.get_tracer_metadata()
    assert names.SPHUM in md
    assert md[names.SPHUM]["i_tracer"] == 1


class ConstantTendencyModel:
    """Mock Predictor (cf. tests/machine_learning_mocks.py:31)."""

    input_variables = [names.TEMP, names.SPHUM]

    def __init__(self, dq1=1e-5, dq2=0.0):
        self.dq1 = dq1
        self.dq2 = dq2

    def predict(self, state):
        t = state[names.TEMP]
        return {
            "dQ1": t.with_data(np.full_like(t.values, self.dq1)),
            "dQ2": t.with_data(np.full_like(t.values, self.dq2)),
        }


@pytest.mark.slow
def test_time_loop_with_ml_stepper(model):
    state = DerivedModelState(wrapper)
    stepper = PureMLStepper(ConstantTendencyModel(), dt=600.0)
    loop = TimeLoop(
        wrapper, state, dt=600.0, postphysics_stepper=stepper, n_steps=2
    )
    times = []
    for time, diags in loop:
        times.append(time)
        assert "water_vapor_path" in diags
        assert (
            "tendency_of_air_temperature_due_to_fv3_dynamics" in diags
        )
        assert "tendency_of_air_temperature_due_to_python" in diags
    assert len(times) == 2
    assert times[1] - times[0] == datetime.timedelta(seconds=600)
    # the ML dQ1 (1e-5 K/s over 600 s) is visible in the python tendency
    tend = diags["tendency_of_air_temperature_due_to_python"].values
    np.testing.assert_allclose(tend.mean(), 1e-5, rtol=0.3)


def test_non_negative_sphum_limiter():
    sphum = np.array([1e-3, 1e-6])
    dQ1 = np.array([0.0, 0.0])
    dQ2 = np.array([-1e-6, -1e-6])  # second one would drive negative
    d1, d2 = non_negative_sphum(sphum, dQ1, dQ2, dt=900.0)
    # first column unchanged
    assert d2[0] == pytest.approx(-1e-6)
    # second limited so humidity stays non-negative
    assert sphum[1] + d2[1] * 900.0 >= -1e-18
    # MSE conservation: cp*d1 + Lv*d2 unchanged
    from fv3net_tpu.constants import CP_AIR, LATENT_HEAT_VAPORIZATION

    lhs = CP_AIR * d1 + LATENT_HEAT_VAPORIZATION * d2
    rhs = CP_AIR * dQ1 + LATENT_HEAT_VAPORIZATION * dQ2
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_renaming_and_multi_model_adapters():
    base = ConstantTendencyModel()
    renamed = RenamingAdapter(
        base, rename_in={"T_renamed": names.TEMP,
                         "q_renamed": names.SPHUM}
    )
    assert "T_renamed" in renamed.input_variables
    q = Quantity(np.zeros((2, 2)), ("y", "x"), "K")
    out = renamed.predict({"T_renamed": q, "q_renamed": q})
    assert "dQ1" in out
    multi = MultiModelAdapter([base])
    assert set(multi.input_variables) == set(base.input_variables)


def test_nudging_stepper(model):
    state = DerivedModelState(wrapper)
    target = state[names.TEMP]
    ref_state = {
        names.TEMP: target.with_data(target.values + 2.0)
    }
    stepper = PureNudger(
        NudgingConfig(timescale_hours={names.TEMP: 2.0}),
        lambda time: ref_state,
    )
    tendencies, diags, _ = stepper(state.time, state)
    np.testing.assert_allclose(
        np.asarray(tendencies["dQ1"].data), 2.0 / 7200.0, rtol=1e-10
    )


def test_prescriber_and_combined(model):
    state = MergedState(DerivedModelState(wrapper))
    mask = np.zeros((model.n, model.n))
    state.overlay[names.MASK] = Quantity(
        np.zeros((6, model.n, model.n)), ("tile", "y", "x"), ""
    )
    new_tsfc = Quantity(
        np.full((6, model.n, model.n), 300.0), ("tile", "y", "x"), "degK"
    )
    presc = Prescriber(
        PrescriberConfig(variables=[names.TSFC]),
        lambda t: {names.TSFC: new_tsfc},
    )
    _, _, updates = presc(state.time, state)
    np.testing.assert_allclose(updates[names.TSFC].values, 300.0)

    combined = CombinedStepper(
        [presc, PureMLStepper(ConstantTendencyModel(), dt=600.0)]
    )
    t, d, u = combined(state.time, state)
    assert "dQ1" in t and names.TSFC in u


def test_metrics(model):
    state = DerivedModelState(wrapper)
    m = compute_metrics(state, model.area)
    assert 9.0e4 < m["area_mean_surface_pressure"] < 1.1e5
    log_metrics(m, state.time)


def test_add_tendency_fills_nans(model):
    state = DerivedModelState(wrapper)
    t = state[names.TEMP]
    tend = {
        "dQ1": t.with_data(np.full_like(t.values, np.nan)),
    }
    from fv3net_tpu.runtime.loop import fillna_tendencies

    filled, diags = fillna_tendencies(tend)
    assert diags["dQ1_filled_frac"].values == 1.0
    out = add_tendency(state, filled, 600.0)
    np.testing.assert_allclose(out[names.TEMP].values, t.values)


@pytest.mark.slow
def test_coupling_hot_path_stays_on_device(model):
    """Accelerator-first coupling (SURVEY hard part 6, VERDICT r2 item 7): one
    TimeLoop step must carry the monitored tendencies and tendency
    application as device (jax) arrays end-to-end -- host
    materialization only at diagnostic sinks (.values)."""
    import jax

    state = DerivedModelState(wrapper)
    stepper = PureMLStepper(ConstantTendencyModel(), dt=600.0)
    loop = TimeLoop(
        wrapper, state, dt=600.0, postphysics_stepper=stepper, n_steps=1
    )
    _, diags = next(iter(loop))
    # the dynamics monitor difference chain never left the device
    tend = diags["tendency_of_air_temperature_due_to_fv3_dynamics"]
    assert isinstance(tend.data, jax.Array), type(tend.data)
    path = diags["storage_of_air_temperature_path_due_to_fv3_dynamics"]
    assert isinstance(path.data, jax.Array)
    # the model's own prognostic state is handed out as device arrays
    st = wrapper.get_state([names.TEMP, names.DELP])
    assert isinstance(st[names.DELP].data, jax.Array)
    assert isinstance(st[names.TEMP].data, jax.Array)


def test_simple_suite_physics_on_device(model):
    """The DEFAULT suite's apply_physics (saturation adjustment) must
    not round-trip through host numpy (VERDICT r3 weak 5; commit
    fa94b62 fixed the GFS path, this guards the simple path).
    jax.transfer_guard raises on any implicit device->host transfer."""
    import jax

    assert wrapper.get_model().config.do_sat_adj
    wrapper.apply_physics()  # warm any jit caches outside the guard
    # device->host is the direction that stalls the device
    # (host->device scalar index uploads from eager slicing are benign)
    with jax.transfer_guard_device_to_host("disallow"):
        wrapper.apply_physics()
    st = wrapper.get_state([names.SPHUM])
    assert isinstance(st[names.SPHUM].data, jax.Array)
    assert isinstance(wrapper.get_model().precip_rate, jax.Array)
