"""chip_smoke.py's phases at toy sizes on the CPU, its refusal to run
without a GPU, the compile-cache helper, and the main path importing
neither flax nor yaml."""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest

from fv3net_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))  # chip_smoke.py and bench.py live there

import chip_smoke  # noqa: E402


def _run_script(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _json_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


def test_device_check_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device(jax.devices("cpu"))


def test_device_check_reports_gpu():
    gpu = types.SimpleNamespace(platform="gpu", device_kind="Some GPU")
    assert chip_smoke.check_device([gpu, gpu]) == {
        "platform": "gpu", "kind": "Some GPU", "count": 2,
    }


def test_script_exits_nonzero_without_gpu():
    r = _run_script(REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not _json_lines(r.stdout)


def test_script_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run_script(tmp_path)
    assert r.returncode != 0
    assert not _json_lines(r.stdout)


def test_dycore_phase_c12():
    cpu = jax.devices("cpu")[0]
    r = chip_smoke.dycore_phase("dycore_c12", 12, 8, 900.0, 2,
                                cpu_device=cpu)
    assert len(r["step_ms"]) == 2
    assert r["mass_drift"] <= chip_smoke.MASS_TOL


def test_kernels_phase_interpret():
    r = chip_smoke.kernels_phase((12,), nz=8, interpret=True)
    assert set(r) == {"sim1_c12"}
    assert r["sim1_c12"]["kernel_ms"] > 0


def test_coupled_phase_small():
    r = chip_smoke.coupled_phase(6, 8, 2, dt=600.0)
    assert len(r["step_ms"]) == 1


# On the CPU the tiled and the face-level float32 programs round alike:
# C12x8 differs by at most 5.3e-7 (w), so a halo error of 1e-4 shows.
TILED_CPU_TOL = 1e-5


def test_four_card_phase_on_virtual_devices():
    """The tiled (1, 2, 2) step on four virtual CPU devices matches
    the one-device step, with every field in four distinct shards, and
    passes the phase's own check against a float64 step."""
    cpu = jax.devices("cpu")[0]
    r = chip_smoke.four_card_phase(12, 8, jax.devices()[:4], n_split=2,
                                   steps=2, cpu_device=cpu)
    assert len(r["step_ms"]) == 2
    for k, err in r["max_rel_diff"].items():
        assert err <= TILED_CPU_TOL, k


def test_four_card_phase_needs_four_devices():
    with pytest.raises(RuntimeError, match="four cards"):
        chip_smoke.four_card_phase(12, 8, jax.devices()[:2])


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_main_path_needs_neither_flax_nor_yaml():
    """With flax and yaml unimportable, a C12 dycore step and the dense
    model's pure_fn still run."""
    code = textwrap.dedent(
        """
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("flax", "yaml"):
                    raise ImportError(name + " is blocked")

        sys.meta_path.insert(0, Block())
        import jax
        import jax.numpy as jnp
        import numpy as np

        import bench
        import chip_smoke  # noqa: F401
        from fv3net_tpu import fit, wrapper  # noqa: F401
        from fv3net_tpu.runtime import compiled_loop  # noqa: F401

        run, state, phis = bench.build_config(12, 5, jax, jnp)
        out = run(state, jnp.asarray(phis), 1)
        assert np.isfinite(np.asarray(out.delp)).all()
        model = bench.dense_ml_model(5)
        arrs = {v: jnp.ones((6, 5, 4, 4), jnp.float32)
                for v in model.input_variables}
        y = model.pure_fn(model.params, arrs)
        assert y["dQ1"].shape == (6, 5, 4, 4)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("flax", "yaml")]
        assert not bad, bad
        print("OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: decided here, never at import."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU")
    return gpus[0]


@pytest.mark.gpu
def test_sim1_kernel_compiled_on_gpu(gpu_device):
    """The Triton kernel as compiled for the card, against the jnp
    scans on the same card."""
    with jax.default_device(gpu_device):
        r = chip_smoke.kernels_phase((12,), nz=63)
    assert np.isfinite(r["sim1_c12"]["kernel_ms"])
