"""Dense-network trainer on JAX (the `dense` training function,
fv3fit/keras/_models/dense.py:90, re-designed for JAX: a plain-jnp MLP
+ optax instead of keras, same Predictor contract and registry name).

The MLP's parameters are a dict {"Dense_i": {"kernel", "bias"}} in the
layout flax's `linen.Dense` stack uses, so model directories written by
earlier flax-based versions (params.npy, the raveled dict) still load.
Only JAX, numpy and optax are needed: the coupled step traces this
model in-graph."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.flatten_util import ravel_pytree

from ._shared import (
    ArrayPacker,
    Predictor,
    StandardScaler,
    register,
    register_training_function,
)


@dataclasses.dataclass
class DenseHyperparameters:
    """(fv3fit DenseHyperparameters subset)"""

    depth: int = 3
    width: int = 64
    epochs: int = 20
    batch_size: int = 512
    learning_rate: float = 1e-3
    seed: int = 0


def _layer_sizes(n_in: int, widths: Sequence[int], n_out: int):
    sizes = [n_in, *widths, n_out]
    return list(zip(sizes[:-1], sizes[1:]))


def init_mlp(key, n_in: int, widths: Sequence[int], n_out: int):
    """LeCun-normal kernels and zero biases (linen.Dense's defaults)."""
    init = jax.nn.initializers.lecun_normal()
    sizes = _layer_sizes(n_in, widths, n_out)
    keys = jax.random.split(key, len(sizes))
    return {
        f"Dense_{i}": {
            "kernel": init(k, (a, b), jnp.float32),
            "bias": jnp.zeros((b,), jnp.float32),
        }
        for i, (k, (a, b)) in enumerate(zip(keys, sizes))
    }


def apply_mlp(params, x):
    """ReLU hidden layers, linear output layer."""
    n = len(params)
    for i in range(n):
        layer = params[f"Dense_{i}"]
        x = x @ layer["kernel"] + layer["bias"]
        if i < n - 1:
            x = jax.nn.relu(x)
    return x


@register("dense")
class DenseModel(Predictor):
    def __init__(self, input_variables, output_variables, packer_in,
                 packer_out, scaler_in, scaler_out, params):
        super().__init__(input_variables, output_variables)
        self.packer_in = packer_in
        self.packer_out = packer_out
        self.scaler_in = scaler_in
        self.scaler_out = scaler_out
        self.params = params
        self._apply = jax.jit(apply_mlp)

    def predict(self, X):
        ref = X[self.input_variables[0]]
        # gate on .data (the raw array): .values is ALWAYS numpy
        # (Quantity.values does np.asarray), so testing it would both
        # miss device states and pay a device->host copy to find out
        if isinstance(getattr(ref, "data", None), jax.Array):
            return self._predict_on_device(X)
        x = self.packer_in.to_array(X)
        xn = self.scaler_in.normalize(x)
        yn = np.asarray(
            self._apply(self.params, jnp.asarray(xn, jnp.float32))
        )
        y = self.scaler_out.denormalize(yn)
        return self.packer_out.to_state(y, self._templates(X))

    def pure_fn(self, params, arrs):
        """The whole pack->normalize->MLP->denormalize->unpack chain as
        a PURE function of (params, {name: array}) -> {name: array}.

        Used two ways: jitted standalone by `_predict_on_device`, and
        traced INSIDE the compiled TimeLoop's fused step
        (runtime/compiled_loop.py) so ML postphysics costs zero extra
        dispatches."""
        blocks = []
        for name in self.input_variables:
            a = arrs[name]
            if a.ndim == 4:
                blocks.append(
                    jnp.moveaxis(a, 1, -1).reshape(-1, a.shape[1])
                )
            elif a.ndim == 3:
                blocks.append(a.reshape(-1, 1))
            else:
                blocks.append(a)
        x = jnp.concatenate(blocks, axis=1)
        xn = (
            x - jnp.asarray(self.scaler_in.mean)
        ) / jnp.asarray(self.scaler_in.std)
        yn = apply_mlp(params, xn.astype(jnp.float32))
        y = yn * jnp.asarray(
            self.scaler_out.std, jnp.float32
        ) + jnp.asarray(self.scaler_out.mean, jnp.float32)
        out = {}
        i = 0
        ref = arrs[self.input_variables[0]]
        for name in self.output_variables:
            w = self.packer_out._feature_counts[name]
            block = y[:, i : i + w]
            i += w
            if ref.ndim == 4 and w > 1:
                t, _, yy, xx = ref.shape
                out[name] = jnp.moveaxis(
                    block.reshape(t, yy, xx, w), -1, 1
                )
            elif ref.ndim == 4:
                t, _, yy, xx = ref.shape
                out[name] = block.reshape(t, yy, xx)
            else:
                out[name] = block
        return out

    def _predict_on_device(self, X):
        """Whole pack->normalize->MLP->denormalize->unpack chain as ONE
        jitted call: jax-array states (the coupled TimeLoop's ML
        stepper) never bounce through the host and never dispatch
        eager per-op kernels."""
        if not hasattr(self, "_dev_fn"):
            self._dev_fn = jax.jit(self.pure_fn)
        arrs = {
            k: X[k].data for k in self.input_variables
        }
        outs = self._dev_fn(self.params, arrs)
        templates = self._templates(X)
        return {
            k: templates[k].with_data(v) for k, v in outs.items()
        }

    def _templates(self, X):
        from ..util.quantity import Quantity

        ref = X[self.input_variables[0]]
        out = {}
        for name in self.output_variables:
            width = self.packer_out._feature_counts[name]
            if len(ref.shape) == 4 and width > 1:
                shape = (ref.shape[0], width, ref.shape[2], ref.shape[3])
                dims = ("tile", "z", "y", "x")
            elif len(ref.shape) == 4:
                shape = (ref.shape[0], ref.shape[2], ref.shape[3])
                dims = ("tile", "y", "x")
            else:
                shape = ref.shape
                dims = ref.dims
            out[name] = Quantity(np.zeros(shape, np.float32), dims, "")
        return out

    def dump(self, path: str):
        self.packer_in.dump(os.path.join(path, "packer_in.json"))
        self.packer_out.dump(os.path.join(path, "packer_out.json"))
        self.scaler_in.dump(os.path.join(path, "scaler_in.npz"))
        self.scaler_out.dump(os.path.join(path, "scaler_out.npz"))
        flat, _ = ravel_pytree(self.params)
        np.save(os.path.join(path, "params.npy"), np.asarray(flat))
        n = len(self.params)
        meta = {
            "input_variables": self.input_variables,
            "output_variables": self.output_variables,
            "widths": [
                int(self.params[f"Dense_{i}"]["bias"].shape[0])
                for i in range(n - 1)
            ],
            "n_out": int(self.params[f"Dense_{n - 1}"]["bias"].shape[0]),
            "n_in": int(self.scaler_in.mean.shape[0]),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "DenseModel":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        params0 = init_mlp(
            jax.random.PRNGKey(0), meta["n_in"], meta["widths"],
            meta["n_out"],
        )
        _, unravel = ravel_pytree(params0)
        flat = np.load(os.path.join(path, "params.npy"))
        params = unravel(jnp.asarray(flat))
        return cls(
            meta["input_variables"],
            meta["output_variables"],
            ArrayPacker.load_from(os.path.join(path, "packer_in.json")),
            ArrayPacker.load_from(os.path.join(path, "packer_out.json")),
            StandardScaler.load_from(os.path.join(path, "scaler_in.npz")),
            StandardScaler.load_from(
                os.path.join(path, "scaler_out.npz")
            ),
            params,
        )


@register_training_function("dense", DenseHyperparameters)
def train_dense_model(
    hyperparameters: DenseHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
) -> DenseModel:
    """Train an MLP mapping stacked input columns to output columns.

    train_batches: iterable of State dicts (each a batch).
    """
    hp = hyperparameters
    batches = list(train_batches)
    packer_in = ArrayPacker(list(input_variables))
    packer_out = ArrayPacker(list(output_variables))
    X = np.concatenate([packer_in.to_array(b) for b in batches])
    Y = np.concatenate([packer_out.to_array(b) for b in batches])
    scaler_in = StandardScaler().fit(X)
    scaler_out = StandardScaler().fit(Y)
    Xn = scaler_in.normalize(X).astype(np.float32)
    Yn = scaler_out.normalize(Y).astype(np.float32)

    key = jax.random.PRNGKey(hp.seed)
    params = init_mlp(key, X.shape[1], (hp.width,) * hp.depth, Y.shape[1])
    tx = optax.adam(hp.learning_rate)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, xb, yb):
        def loss_fn(p):
            pred = apply_mlp(p, xb)
            return jnp.mean((pred - yb) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    nsamp = Xn.shape[0]
    rng = np.random.RandomState(hp.seed)
    for epoch in range(hp.epochs):
        perm = rng.permutation(nsamp)
        for i in range(0, nsamp, hp.batch_size):
            sel = perm[i : i + hp.batch_size]
            params, opt_state, loss = step(
                params, opt_state, jnp.asarray(Xn[sel]),
                jnp.asarray(Yn[sel]),
            )
    return DenseModel(
        list(input_variables), list(output_variables), packer_in,
        packer_out, scaler_in, scaler_out, params,
    )
