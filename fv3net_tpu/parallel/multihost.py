"""Multi-host (multi-process) runtime: the mpirun replacement.

The reference launches one OS process per rank with
``mpirun -n 6*x*y python -m mpi4py runtime/main.py``
(workflows/prognostic_c48_run/runtime/segmented_run/run.py:36-50) and
couples them with MPI through FMS/pace.util.  The JAX
equivalent (SURVEY 2.3): each host calls ``jax.distributed.initialize``
against a shared coordinator, all hosts see one GLOBAL device list,
and a single ``jax.sharding.Mesh`` over those devices makes the
shard_map/ppermute halo exchanges ride the device interconnect within
a host and the network across hosts — placement follows device order, which JAX groups by
process, so contiguous face/tile blocks land process-local.

On CPU backends (tests; the reference's own deployment target is CPU
clusters) cross-process collectives use the gloo transport; a
2-process bit-equality test drives the tiled C12 step in
tests/test_multihost.py, mirroring the reference's DummyComm-based
multi-rank testing strategy (SURVEY 4.3).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join (or create) the distributed runtime; returns
    (process_id, num_processes).

    Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID), so
    a launcher can configure ranks exactly like mpirun does with
    OMPI_COMM_WORLD_RANK.  Single-process when nothing is configured.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if coordinator_address is None or num_processes <= 1:
        return 0, 1
    # NOTE: must not touch the backend (jax.devices/default_backend)
    # before jax.distributed.initialize; inspect the CONFIGURED
    # platform string instead.
    platforms = (
        jax.config.jax_platforms
        or os.environ.get("JAX_PLATFORMS", "")
    )
    if "cpu" in str(platforms):
        # cross-process CPU collectives need the gloo transport
        jax.config.update(
            "jax_cpu_collectives_implementation", "gloo"
        )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return process_id, num_processes


def global_face_mesh(
    layout: Optional[Sequence[int]] = None,
) -> Mesh:
    """A (face[, y, x]) mesh over the GLOBAL device list.

    layout: within-face (y, x) tiling; defaults to (1, 1) (6 devices,
    face-only — the reference's layout=[1,1] 6-rank configuration).
    Total devices must equal 6*y*x.  Device order groups by process,
    so whole faces (or contiguous tile blocks) stay process-local and
    the inter-face exchanges become the only cross-process traffic.
    """
    y, x = tuple(layout) if layout is not None else (1, 1)
    devices = np.asarray(jax.devices())
    need = 6 * y * x
    if devices.size != need:
        raise ValueError(
            f"global_face_mesh(layout={(y, x)}) needs {need} devices, "
            f"got {devices.size}"
        )
    if y == x == 1:
        return Mesh(devices.reshape(6), ("face",))
    return Mesh(devices.reshape(6, y, x), ("face", "y", "x"))


def make_global_array(host_value: np.ndarray, mesh: Mesh, spec: P):
    """Build a globally-sharded array from a host-replicated numpy
    value (every process holds the full field, as after reading a
    restart; the runtime equivalent of pace.util scatter,
    runtime/scatter.py:11)."""
    sharding = NamedSharding(mesh, spec)
    host_value = np.asarray(host_value)
    return jax.make_array_from_callback(
        host_value.shape, sharding, lambda idx: host_value[idx]
    )


def process_local_faces(mesh: Mesh) -> Sequence[int]:
    """Which face indices this process owns (for per-rank IO)."""
    axis = mesh.axis_names.index("face")
    faces = []
    for d, idx in zip(
        mesh.devices.flat,
        np.ndindex(*mesh.devices.shape),
    ):
        if d.process_index == jax.process_index():
            faces.append(idx[axis])
    return sorted(set(faces))
