"""ML framework tests: training functions, io registry round-trips,
composite models, novelty detection -- the fv3fit test strategy
(SURVEY 4.1) against this framework."""

import numpy as np
import pytest

import fv3net_tpu.fit as fit
from fv3net_tpu.data import SyntheticWaves, SyntheticNoise
from fv3net_tpu.util.quantity import Quantity


@pytest.fixture(scope="module")
def wave_batches():
    return SyntheticWaves(
        ["a_in", "b_out"], n=6, nz=5, nbatch=3, seed=1
    ).batches()


def test_dense_training_and_roundtrip(tmp_path, wave_batches):
    # b_out = f(a_in) is learnable (they share the wave structure)
    model = fit.train_dense_model(
        fit.DenseHyperparameters(depth=2, width=32, epochs=30),
        wave_batches,
        input_variables=["a_in"],
        output_variables=["b_out"],
    )
    pred = model.predict(wave_batches[0])
    assert pred["b_out"].shape == wave_batches[0]["b_out"].shape
    # save / load through the io registry
    fit.dump(model, str(tmp_path / "model"))
    loaded = fit.load(str(tmp_path / "model"))
    pred2 = loaded.predict(wave_batches[0])
    np.testing.assert_allclose(
        pred["b_out"].values, pred2["b_out"].values, rtol=1e-5,
        atol=1e-5,
    )


def test_dense_learns_identity():
    batches = SyntheticWaves(["x"], n=6, nz=4, nbatch=4,
                             seed=3).batches()
    for b in batches:
        b["y"] = b["x"].with_data(2.0 * np.asarray(b["x"].data))
    model = fit.train_dense_model(
        fit.DenseHyperparameters(depth=2, width=64, epochs=60),
        batches,
        input_variables=["x"],
        output_variables=["y"],
    )
    pred = model.predict(batches[0])
    err = np.abs(
        pred["y"].values - 2.0 * batches[0]["x"].values
    ).mean()
    scale = np.abs(batches[0]["x"].values).mean()
    assert err < 0.2 * scale, err


@pytest.mark.parametrize("depth", [1, 11])
def test_dense_loads_flax_layout_params(tmp_path, wave_batches, depth):
    """params.npy holds the raveled {"Dense_i": {"bias", "kernel"}}
    dict in flax's order (keys sorted as strings, bias before kernel),
    so model directories written by flax-based versions still load;
    depth 11 puts Dense_10 before Dense_2."""
    model = fit.train_dense_model(
        fit.DenseHyperparameters(depth=depth, width=3, epochs=1),
        wave_batches,
        input_variables=["a_in"],
        output_variables=["b_out"],
    )
    path = str(tmp_path / "model")
    fit.dump(model, path)
    rng = np.random.RandomState(depth)
    sizes = [5] + [3] * depth + [5]
    layers = {
        f"Dense_{i}": {
            "bias": rng.randn(b).astype(np.float32),
            "kernel": rng.randn(a, b).astype(np.float32),
        }
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))
    }
    flat = np.concatenate([
        layers[k][leaf].ravel()
        for k in sorted(layers) for leaf in ("bias", "kernel")
    ])
    np.save(tmp_path / "model" / "params.npy", flat)
    loaded = fit.load(path)
    for k, leaves in layers.items():
        for leaf, want in leaves.items():
            np.testing.assert_array_equal(
                np.asarray(loaded.params[k][leaf]), want
            )
    x = rng.randn(7, 5).astype(np.float32)
    want = x
    for i in range(depth + 1):
        want = want @ layers[f"Dense_{i}"]["kernel"]
        want = want + layers[f"Dense_{i}"]["bias"]
        if i < depth:
            want = np.maximum(want, 0.0)
    np.testing.assert_allclose(
        np.asarray(loaded._apply(loaded.params, x)), want, rtol=1e-5,
        atol=1e-5,
    )


def test_random_forest(tmp_path, wave_batches):
    model = fit.train_random_forest(
        fit.RandomForestHyperparameters(n_estimators=5, max_depth=5),
        wave_batches,
        input_variables=["a_in"],
        output_variables=["b_out"],
    )
    pred = model.predict(wave_batches[0])
    assert pred["b_out"].shape == wave_batches[0]["b_out"].shape
    fit.dump(model, str(tmp_path / "rf"))
    loaded = fit.load(str(tmp_path / "rf"))
    np.testing.assert_allclose(
        pred["b_out"].values,
        loaded.predict(wave_batches[0])["b_out"].values,
    )


def test_training_function_registry():
    assert "dense" in fit.TRAINING_FUNCTIONS
    assert "sklearn_random_forest" in fit.TRAINING_FUNCTIONS
    assert "min_max_novelty_detector" in fit.TRAINING_FUNCTIONS
    fn = fit.get_training_function("dense")
    assert fn is fit.train_dense_model


def test_min_max_novelty_detector(tmp_path, wave_batches):
    det = fit.train_min_max_novelty_detector(
        None, wave_batches, input_variables=["a_in"]
    )
    # in-sample data is not novel
    score = det.predict_novelty_score(wave_batches[0])
    assert (score <= 0).all()
    # out-of-range data is
    crazy = {
        "a_in": wave_batches[0]["a_in"].with_data(
            np.asarray(wave_batches[0]["a_in"].data) + 100.0
        )
    }
    assert (det.predict_novelty_score(crazy) > 0).all()
    fit.dump(det, str(tmp_path / "novelty"))
    loaded = fit.load(str(tmp_path / "novelty"))
    assert (loaded.predict_novelty_score(crazy) > 0).all()


def test_ensemble_and_combined_and_tapered(wave_batches):
    c1 = fit.ConstantOutputPredictor(["a_in"], ["o1"], {"o1": 1.0})
    c2 = fit.ConstantOutputPredictor(["a_in"], ["o1"], {"o1": 3.0})
    ens = fit.EnsembleModel([c1, c2])
    out = ens.predict(wave_batches[0])
    np.testing.assert_allclose(out["o1"].values, 2.0)

    c3 = fit.ConstantOutputPredictor(["a_in"], ["o2"], {"o2": 5.0})
    comb = fit.CombinedOutputModel([c1, c3])
    out = comb.predict(wave_batches[0])
    assert set(out) == {"o1", "o2"}

    tap = fit.TaperedModel(c1, cutoff=2, rate=0.5)
    out = tap.predict(wave_batches[0])
    arr = out["o1"].values
    assert arr[:, 0].mean() < 0.2  # tapered near the top
    assert arr[:, -1].mean() > 0.8


def test_out_of_sample_model(wave_batches):
    base = fit.ConstantOutputPredictor(["a_in"], ["o"], {"o": 1.0})
    det = fit.train_min_max_novelty_detector(
        None, wave_batches, input_variables=["a_in"]
    )
    oos = fit.OutOfSampleModel(base, det)
    out = oos.predict(wave_batches[0])
    np.testing.assert_allclose(out["o"].values, 1.0)
    crazy = {
        "a_in": wave_batches[0]["a_in"].with_data(
            np.asarray(wave_batches[0]["a_in"].data) + 100.0
        )
    }
    out = oos.predict(crazy)
    np.testing.assert_allclose(out["o"].values, 0.0)


def test_train_cli(tmp_path):
    import yaml

    from fv3net_tpu.fit.train import main

    tc = tmp_path / "train.yml"
    dc = tmp_path / "data.yml"
    out = tmp_path / "model_out"
    yaml.safe_dump(
        {
            "model_type": "dense",
            "hyperparameters": {"depth": 1, "width": 8, "epochs": 2},
            "input_variables": ["a"],
            "output_variables": ["b"],
        },
        open(tc, "w"),
    )
    yaml.safe_dump(
        {
            "function": "synthetic_waves",
            "kwargs": {"variables": ["a", "b"], "n": 6, "nz": 3,
                       "nbatch": 2},
        },
        open(dc, "w"),
    )
    main([str(tc), str(dc), str(out),
          "hyperparameters.epochs=1"])
    loaded = fit.load(str(out))
    assert loaded.input_variables == ["a"]
