"""Precipitative trainer (the `precipitative` training function,
fv3fit/keras/_models/precipitative.py:162).

Predicts column heating (dQ1), column moistening (dQ2) and surface
precipitation with the reference's physical coupling: the surface
precipitation output is the column integral of the drying
  P = -<dQ2> = -sum_k dQ2_k * delp_k / g   (clipped to P >= 0)
plus a learned residual column-process term, so the model's water
budget closes by construction.  One flax MLP trunk with
two linear heads, trained end-to-end with the precip constraint inside
the loss graph.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import linen as nn

from ._shared import (
    ArrayPacker,
    Predictor,
    StandardScaler,
    register,
    register_training_function,
)
from ..constants import GRAV

DELP = "pressure_thickness_of_atmospheric_layer"
PRECIP = "total_precipitation_rate"
Q1 = "dQ1"
Q2 = "dQ2"


@dataclasses.dataclass
class PrecipitativeHyperparameters:
    """(fv3fit PrecipitativeHyperparameters subset)"""

    depth: int = 3
    width: int = 64
    epochs: int = 20
    batch_size: int = 512
    learning_rate: float = 1e-3
    precip_loss_weight: float = 1.0
    seed: int = 0


class _Trunk(nn.Module):
    widths: Sequence[int]
    nz: int

    @nn.compact
    def __call__(self, x):
        h = x
        for w in self.widths:
            h = nn.relu(nn.Dense(w)(h))
        q1 = nn.Dense(self.nz, name="q1_head")(h)
        q2 = nn.Dense(self.nz, name="q2_head")(h)
        residual = nn.Dense(1, name="precip_residual")(h)
        return q1, q2, residual


def _physical_precip(q2_phys, delp, residual):
    """P = relu(-<dQ2> + residual) in kg/m^2/s (mm/s water equiv.)."""
    col = -(q2_phys * delp).sum(axis=-1) / GRAV
    return jax.nn.relu(col + residual[..., 0])


@register("precipitative")
class PrecipitativeModel(Predictor):
    def __init__(self, input_variables, packer_in, scaler_in,
                 scaler_q1, scaler_q2, module, params, nz):
        super().__init__(
            input_variables, [Q1, Q2, PRECIP]
        )
        self.packer_in = packer_in
        self.scaler_in = scaler_in
        self.scaler_q1 = scaler_q1
        self.scaler_q2 = scaler_q2
        self.module = module
        self.params = params
        self.nz = nz

        def fwd(p, xn, delp):
            q1n, q2n, res = self.module.apply({"params": p}, xn)
            q1 = q1n * self.scaler_q1.std + self.scaler_q1.mean
            q2 = q2n * self.scaler_q2.std + self.scaler_q2.mean
            precip = _physical_precip(q2, delp, res)
            return q1, q2, precip

        self._fwd = jax.jit(fwd)

    def predict(self, X):
        from ..util.quantity import Quantity

        x = self.packer_in.to_array(X)
        xn = self.scaler_in.normalize(x).astype(np.float32)
        delp_q = X[DELP]
        delp = np.moveaxis(
            np.asarray(delp_q.values, np.float32), 1, -1
        ).reshape(-1, self.nz)
        q1, q2, precip = self._fwd(
            self.params, jnp.asarray(xn), jnp.asarray(delp)
        )
        tshape = delp_q.shape  # [tile, z, y, x]

        def unstack(a):
            arr = np.asarray(a).reshape(
                tshape[0], tshape[2], tshape[3], self.nz
            )
            return np.moveaxis(arr, -1, 1)

        return {
            Q1: Quantity(unstack(q1), ("tile", "z", "y", "x"), "K/s"),
            Q2: Quantity(unstack(q2), ("tile", "z", "y", "x"),
                         "kg/kg/s"),
            PRECIP: Quantity(
                np.asarray(precip).reshape(
                    tshape[0], tshape[2], tshape[3]
                ),
                ("tile", "y", "x"), "kg/m**2/s",
            ),
        }

    def dump(self, path: str):
        self.packer_in.dump(os.path.join(path, "packer_in.json"))
        self.scaler_in.dump(os.path.join(path, "scaler_in.npz"))
        self.scaler_q1.dump(os.path.join(path, "scaler_q1.npz"))
        self.scaler_q2.dump(os.path.join(path, "scaler_q2.npz"))
        flat, _ = jax.flatten_util.ravel_pytree(self.params)
        np.save(os.path.join(path, "params.npy"), np.asarray(flat))
        meta = {
            "input_variables": self.input_variables,
            "widths": list(self.module.widths),
            "nz": self.nz,
            "n_in": int(self.scaler_in.mean.shape[0]),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "PrecipitativeModel":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        module = _Trunk(tuple(meta["widths"]), meta["nz"])
        params0 = module.init(
            jax.random.PRNGKey(0), jnp.zeros((1, meta["n_in"]))
        )["params"]
        _, unravel = jax.flatten_util.ravel_pytree(params0)
        flat = np.load(os.path.join(path, "params.npy"))
        return cls(
            meta["input_variables"],
            ArrayPacker.load_from(os.path.join(path, "packer_in.json")),
            StandardScaler.load_from(os.path.join(path, "scaler_in.npz")),
            StandardScaler.load_from(os.path.join(path, "scaler_q1.npz")),
            StandardScaler.load_from(os.path.join(path, "scaler_q2.npz")),
            module,
            unravel(jnp.asarray(flat)),
            meta["nz"],
        )


@register_training_function(
    "precipitative", PrecipitativeHyperparameters
)
def train_precipitative_model(
    hyperparameters: PrecipitativeHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
) -> PrecipitativeModel:
    """Targets required in each batch: dQ1, dQ2,
    total_precipitation_rate; delp must be among the inputs."""
    hp = hyperparameters
    if DELP not in input_variables:
        raise ValueError(f"precipitative model requires {DELP} input")
    batches = list(train_batches)
    packer_in = ArrayPacker(list(input_variables))
    pack_q1 = ArrayPacker([Q1])
    pack_q2 = ArrayPacker([Q2])
    pack_p = ArrayPacker([PRECIP])
    pack_delp = ArrayPacker([DELP])
    X = np.concatenate([packer_in.to_array(b) for b in batches])
    Yq1 = np.concatenate([pack_q1.to_array(b) for b in batches])
    Yq2 = np.concatenate([pack_q2.to_array(b) for b in batches])
    Yp = np.concatenate([pack_p.to_array(b) for b in batches])[:, 0]
    D = np.concatenate([pack_delp.to_array(b) for b in batches])
    nz = Yq1.shape[1]

    scaler_in = StandardScaler().fit(X)
    scaler_q1 = StandardScaler().fit(Yq1)
    scaler_q2 = StandardScaler().fit(Yq2)
    Xn = scaler_in.normalize(X).astype(np.float32)
    Yq1n = scaler_q1.normalize(Yq1).astype(np.float32)
    Yq2n = scaler_q2.normalize(Yq2).astype(np.float32)
    p_scale = float(Yp.std() + 1e-12)

    module = _Trunk((hp.width,) * hp.depth, nz)
    params = module.init(
        jax.random.PRNGKey(hp.seed), jnp.zeros((1, X.shape[1]))
    )["params"]
    tx = optax.adam(hp.learning_rate)
    opt_state = tx.init(params)
    s_q2_std = jnp.asarray(scaler_q2.std, jnp.float32)
    s_q2_mean = jnp.asarray(scaler_q2.mean, jnp.float32)

    @jax.jit
    def step(params, opt_state, xb, y1b, y2b, pb, db):
        def loss_fn(p):
            q1n, q2n, res = module.apply({"params": p}, xb)
            q2_phys = q2n * s_q2_std + s_q2_mean
            pred_p = _physical_precip(q2_phys, db, res)
            return (
                jnp.mean((q1n - y1b) ** 2)
                + jnp.mean((q2n - y2b) ** 2)
                + hp.precip_loss_weight
                * jnp.mean(((pred_p - pb) / p_scale) ** 2)
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    nsamp = Xn.shape[0]
    rng = np.random.RandomState(hp.seed)
    for epoch in range(hp.epochs):
        perm = rng.permutation(nsamp)
        for i in range(0, nsamp, hp.batch_size):
            sel = perm[i : i + hp.batch_size]
            params, opt_state, _ = step(
                params, opt_state, jnp.asarray(Xn[sel]),
                jnp.asarray(Yq1n[sel]), jnp.asarray(Yq2n[sel]),
                jnp.asarray(Yp[sel].astype(np.float32)),
                jnp.asarray(D[sel].astype(np.float32)),
            )
    return PrecipitativeModel(
        list(input_variables), packer_in, scaler_in, scaler_q1,
        scaler_q2, module, params, nz,
    )
