"""Convolutional trainer on the cubed sphere (the `convolutional`
training function, fv3fit/keras/_models/convolutional.py:101).

The reference appends cube-topology halos to each tile with
pace.util DummyComm machinery (fv3fit/keras/_models/shared/
halos.py:10-60) and runs a keras CNN with VALID padding so the output
is exactly the interior.  Here the halo append IS the framework's
halo_exchange gather (grid/halo.py:65) -- the same edge/corner
rotation semantics, executed as one XLA gather -- and the CNN is a
flax module, so train and predict both run jitted on the accelerator.

Fields are packed [6, y, x, channels] with z as channels (the
reference stacks [tile, x, y, z] the same way, convolutional.py:92).
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
    Predictor,
    StandardScaler,
    register,
    register_training_function,
)
from ..grid.halo import halo_exchange


@dataclasses.dataclass
class ConvolutionalHyperparameters:
    """(fv3fit ConvolutionalHyperparameters subset)"""

    filters: int = 32
    depth: int = 2  # conv layers; receptive radius = depth*(kernel//2)
    kernel_size: int = 3
    epochs: int = 10
    learning_rate: float = 1e-3
    seed: int = 0


class _CNN(nn.Module):
    filters: int
    depth: int
    kernel: int
    n_out: int

    @nn.compact
    def __call__(self, x):  # [batch, y+2h, x+2h, c]
        for _ in range(self.depth):
            x = nn.relu(
                nn.Conv(self.filters, (self.kernel, self.kernel),
                        padding="VALID")(x)
            )
        return nn.Conv(self.n_out, (1, 1))(x)


def _halo_radius(hp: ConvolutionalHyperparameters) -> int:
    return hp.depth * (hp.kernel_size // 2)


def _stack_channels(state, names):
    """[6, z, y, x] fields -> [6, y, x, sum(z)]; 2D fields add one
    channel.  Returns (array, per-name widths); width 0 marks a 2D
    [6, y, x] field (so a z=1 3D field stays distinguishable)."""
    blocks, widths = [], {}
    for name in names:
        arr = np.asarray(state[name].values, np.float32)
        if arr.ndim == 4:
            blocks.append(np.moveaxis(arr, 1, -1))
            widths[name] = arr.shape[1]
        elif arr.ndim == 3:
            blocks.append(arr[..., None])
            widths[name] = 0
        else:
            raise ValueError(f"bad rank for {name}: {arr.shape}")
    return np.concatenate(blocks, axis=-1), widths


def _num_channels(widths) -> int:
    return int(sum(max(w, 1) for w in widths.values()))


def _unstack_channels(y, names, widths):
    """Inverse of _stack_channels: [..., y, x, c] -> Quantity dict."""
    from ..util.quantity import Quantity

    out, i = {}, 0
    for name in names:
        w = widths[name]
        wc = max(w, 1)
        block = y[..., i : i + wc]
        i += wc
        if w == 0:
            out[name] = Quantity(block[..., 0], ("tile", "y", "x"), "")
        else:
            out[name] = Quantity(
                np.moveaxis(block, -1, 1), ("tile", "z", "y", "x"), ""
            )
    return out


def append_halos(tilewise: jnp.ndarray, n_halo: int) -> jnp.ndarray:
    """Cube-topology halo append for [6, y, x, c] channel-last data
    (the fv3fit append_halos contract, halos.py:10)."""
    moved = jnp.moveaxis(tilewise, -1, 1)  # [6, c, y, x]
    padded = halo_exchange(moved, n_halo)
    return jnp.moveaxis(padded, 1, -1)


@register("convolutional")
class ConvolutionalModel(Predictor):
    def __init__(self, input_variables, output_variables, widths_in,
                 widths_out, scaler_in, scaler_out, module, params,
                 n_halo):
        super().__init__(input_variables, output_variables)
        self.widths_in = widths_in
        self.widths_out = widths_out
        self.scaler_in = scaler_in
        self.scaler_out = scaler_out
        self.module = module
        self.params = params
        self.n_halo = n_halo

        def fwd(p, x):
            xh = append_halos(x, n_halo) if n_halo else x
            return self.module.apply({"params": p}, xh)

        self._apply = jax.jit(fwd)

    def predict(self, X):
        from ..util.quantity import Quantity

        x, _ = _stack_channels(X, self.input_variables)
        xn = (x - self.scaler_in.mean) / self.scaler_in.std
        yn = np.asarray(
            self._apply(self.params, jnp.asarray(xn, jnp.float32))
        )
        y = yn * self.scaler_out.std + self.scaler_out.mean
        return _unstack_channels(
            y, self.output_variables, self.widths_out
        )

    def dump(self, path: str):
        self.scaler_in.dump(os.path.join(path, "scaler_in.npz"))
        self.scaler_out.dump(os.path.join(path, "scaler_out.npz"))
        flat, _ = jax.flatten_util.ravel_pytree(self.params)
        np.save(os.path.join(path, "params.npy"), np.asarray(flat))
        meta = {
            "input_variables": self.input_variables,
            "output_variables": self.output_variables,
            "widths_in": self.widths_in,
            "widths_out": self.widths_out,
            "filters": self.module.filters,
            "depth": self.module.depth,
            "kernel": self.module.kernel,
            "n_out": self.module.n_out,
            "n_halo": self.n_halo,
            "n_in": _num_channels(self.widths_in),
            # v2: width 0 marks a 2D [6, y, x] field (v1 used width 1,
            # which collides with a z=1 3D field)
            "format_version": 2,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "ConvolutionalModel":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format_version", 1) < 2:
            # v1 checkpoints marked 2D fields with width 1; translate so
            # predict() returns ("tile","y","x") for them as before
            meta["widths_in"] = {
                k: 0 if w == 1 else w
                for k, w in meta["widths_in"].items()
            }
            meta["widths_out"] = {
                k: 0 if w == 1 else w
                for k, w in meta["widths_out"].items()
            }
        module = _CNN(meta["filters"], meta["depth"], meta["kernel"],
                      meta["n_out"])
        k = meta["kernel"] + 2 * meta["n_halo"]
        params0 = module.init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, k + 4, k + 4, meta["n_in"])),
        )["params"]
        flat0, unravel = jax.flatten_util.ravel_pytree(params0)
        flat = np.load(os.path.join(path, "params.npy"))
        scaler_in = StandardScaler.load_from(
            os.path.join(path, "scaler_in.npz")
        )
        scaler_out = StandardScaler.load_from(
            os.path.join(path, "scaler_out.npz")
        )
        return cls(
            meta["input_variables"], meta["output_variables"],
            meta["widths_in"], meta["widths_out"], scaler_in,
            scaler_out, module, unravel(jnp.asarray(flat)),
            meta["n_halo"],
        )


@register_training_function(
    "convolutional", ConvolutionalHyperparameters
)
def train_convolutional_model(
    hyperparameters: ConvolutionalHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
) -> ConvolutionalModel:
    hp = hyperparameters
    batches = list(train_batches)
    Xs, Ys = [], []
    for b in batches:
        x, widths_in = _stack_channels(b, input_variables)
        y, widths_out = _stack_channels(b, output_variables)
        Xs.append(x)
        Ys.append(y)
    X = np.concatenate(Xs)  # [n_tiles_total, y, x, c]
    Y = np.concatenate(Ys)

    class _ChannelScaler(StandardScaler):
        def fit(self, A):
            self.mean = A.mean(axis=(0, 1, 2))
            self.std = A.std(axis=(0, 1, 2)) + self.std_epsilon
            return self

    scaler_in = _ChannelScaler().fit(X)
    scaler_out = _ChannelScaler().fit(Y)
    Xn = ((X - scaler_in.mean) / scaler_in.std).astype(np.float32)
    Yn = ((Y - scaler_out.mean) / scaler_out.std).astype(np.float32)

    n_halo = _halo_radius(hp)
    module = _CNN(hp.filters, hp.depth, hp.kernel_size, Y.shape[-1])
    key = jax.random.PRNGKey(hp.seed)
    ny = X.shape[1] + 2 * n_halo
    params = module.init(
        key, jnp.zeros((1, ny, ny, X.shape[-1]))
    )["params"]
    tx = optax.adam(hp.learning_rate)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, xb, yb):
        def loss_fn(p):
            xh = append_halos(xb, n_halo) if n_halo else xb
            pred = module.apply({"params": p}, xh)
            return jnp.mean((pred - yb) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    # each batch is one cube (6 tiles) -- halo append needs whole cubes
    xb_all = jnp.asarray(Xn)
    yb_all = jnp.asarray(Yn)
    n_cubes = X.shape[0] // 6
    for epoch in range(hp.epochs):
        for c in range(n_cubes):
            params, opt_state, loss = step(
                params, opt_state,
                xb_all[6 * c : 6 * (c + 1)],
                yb_all[6 * c : 6 * (c + 1)],
            )
    return ConvolutionalModel(
        list(input_variables), list(output_variables), widths_in,
        widths_out, scaler_in, scaler_out, module, params, n_halo,
    )
