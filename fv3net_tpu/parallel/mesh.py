"""Device-mesh partitioning for the cubed sphere.

The JAX replacement for the reference's MPI domain decomposition
(pace.util CubedSpherePartitioner / TilePartitioner + mpirun -n 6xy,
SURVEY 2.3): a `jax.sharding.Mesh` over (face, z) -- and, for larger
slices, (face, y, x) -- with fields placed by NamedSharding.  Under jit
the XLA SPMD partitioner turns the halo-exchange gathers and global
reductions into device collectives automatically; the explicit
shard_map+ppermute edge exchange is the planned optimization for
production halos.

Layout policy (mirrors the 6*x*y rank-count rule of
runtime/segmented_run/run.py:34-35):
    n_devices in {1,2,3,6}: shard faces only
    n_devices = 6*k: faces x z (or faces x y once y-sharding lands)
    otherwise: largest face factor in {3,2,1} x z-sharding
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@dataclasses.dataclass
class CubedSphereMesh:
    """A device mesh with the cube's face axis first."""

    mesh: Mesh
    face_shards: int
    z_shards: int

    @property
    def n_devices(self) -> int:
        return self.face_shards * self.z_shards

    def sharding_3d(self) -> NamedSharding:
        """[6, nz, y, x] fields: shard faces and levels."""
        return NamedSharding(self.mesh, P("face", "z", None, None))

    def sharding_2d(self) -> NamedSharding:
        return NamedSharding(self.mesh, P("face", None, None))

    def sharding_replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())


def _face_factor(n: int) -> int:
    for f in (6, 3, 2):
        if n % f == 0:
            return f
    return 1


def make_mesh(n_devices: Optional[int] = None) -> CubedSphereMesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    f = _face_factor(n)
    z = n // f
    mesh = Mesh(
        np.array(devices[:n]).reshape(f, z), ("face", "z")
    )
    return CubedSphereMesh(mesh, f, z)


def shard_state(state, csm: CubedSphereMesh):
    """Place a DycoreState (or any pytree of [6, nz, ...] arrays) on the
    mesh."""

    def place(x):
        if x is None:
            return None
        if x.ndim >= 2 and x.shape[0] == 6:
            nz_ok = x.ndim >= 2 and (
                x.shape[1] % csm.z_shards == 0
            )
            spec = (
                P("face", "z", *([None] * (x.ndim - 2)))
                if nz_ok and x.ndim > 2
                else P("face", *([None] * (x.ndim - 1)))
            )
            return jax.device_put(x, NamedSharding(csm.mesh, spec))
        return jax.device_put(x, csm.sharding_replicated())

    return jax.tree_util.tree_map(place, state)


def global_mean(field, area):
    """Area-weighted global mean; a psum over the mesh under jit (the
    comm.reduce replacement of runtime/metrics.py:18-33)."""
    import jax.numpy as jnp

    return jnp.sum(field * area) / jnp.sum(area)
