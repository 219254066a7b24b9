"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests run on the CPU unless JAX_PLATFORMS names other platforms (the
few that need a GPU carry the `gpu` marker and skip on the CPU; on the
card: `JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`);
multi-device sharding is exercised
with xla_force_host_platform_device_count (mirrors the reference's
DummyComm approach to testing MPI logic in one process,
pace.util.testing, used e.g. at
workflows/prognostic_c48_run/tests/test_prescriber.py:98).
"""

import os

platforms = os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    # 24 virtual devices: enough for the (face=6, y=2, x=2) within-face
    # tiled mesh (tests/test_tiled_dycore.py); face-only tests use the
    # first 6-8.
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=24"
    ).strip()

import jax  # noqa: E402

# set the platforms via config too, in case a site plugin overrides the
# environment variable
jax.config.update("jax_platforms", platforms)
jax.config.update("jax_enable_x64", True)
