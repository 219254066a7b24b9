"""Graph-network trainer on the cubed sphere (the `graph` training
function, reference fv3fit/pytorch/graph/train.py:65 — UNet / MPG
message-passing architectures over cubed-sphere nodes).

Design: the reference builds an explicit edge list over grid nodes and
runs torch message passing (gather/scatter).  On the cube the graph is a fixed-degree 4-neighbor grid
graph whose only irregularity is the 12 face seams, so message
passing factorizes into (a) a cube-topology halo exchange (one XLA
gather, `grid/halo.py`) and (b) axis shifts of the padded block —
every aggregation is a dense [6, y, x, c] tensor op and the node/edge
MLPs are batched matmuls.  The graph-UNet variant pools by
2x2 block means (exact on the quad-tree the cubed sphere defines) and
unpools by nearest-neighbor upsampling, mirroring the reference's
coarsen/refine levels.
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
from .convolutional import (
    _num_channels,
    _stack_channels,
    _unstack_channels,
    append_halos,
)


@dataclasses.dataclass
class GraphHyperparameters:
    """(fv3fit/pytorch/graph/train.py GraphHyperparameters subset)"""

    architecture: str = "mpg"  # "mpg" (message passing) | "unet"
    width: int = 32
    depth: int = 3  # message-passing rounds / unet levels
    epochs: int = 10
    learning_rate: float = 1e-3
    seed: int = 0


class _MessagePassing(nn.Module):
    """One round: aggregate 4-neighbor messages (via halo-exchanged
    shifts), then a node-update MLP.  Residual."""

    width: int

    @nn.compact
    def __call__(self, x):  # [6, y, x, c] cube-tile block
        h = append_halos(x, 1)  # [6, y+2, x+2, c]
        north = h[:, 2:, 1:-1]
        south = h[:, :-2, 1:-1]
        east = h[:, 1:-1, 2:]
        west = h[:, 1:-1, :-2]
        # edge MLP on (node, neighbor) pairs, summed over neighbors
        msgs = 0.0
        for nb in (north, south, east, west):
            msgs = msgs + nn.Dense(self.width)(
                jnp.concatenate([x, nb], axis=-1)
            )
        upd = nn.Dense(self.width)(
            jnp.concatenate([x, nn.relu(msgs)], axis=-1)
        )
        return x + nn.relu(upd) if x.shape[-1] == self.width else \
            nn.relu(upd)


class _GraphMPG(nn.Module):
    width: int
    depth: int
    n_out: int

    @nn.compact
    def __call__(self, x):
        x = nn.Dense(self.width)(x)
        for _ in range(self.depth):
            x = _MessagePassing(self.width)(x)
        return nn.Dense(self.n_out)(x)


def _pool2(x):  # [6, y, x, c] -> [6, y/2, x/2, c] block mean
    s = x.shape
    return x.reshape(s[0], s[1] // 2, 2, s[2] // 2, 2, s[3]).mean(
        (2, 4)
    )


def _unpool2(x):  # nearest-neighbor upsample
    return jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)


class _GraphUNet(nn.Module):
    """Graph-UNet: message passing at each level of the cube quad-tree
    with skip connections (reference graph UNet architecture)."""

    width: int
    depth: int
    n_out: int

    @nn.compact
    def __call__(self, x):
        x = nn.Dense(self.width)(x)
        skips = []
        for level in range(self.depth):
            x = _MessagePassing(self.width)(x)
            skips.append(x)
            if min(x.shape[1], x.shape[2]) >= 4:
                x = _pool2(x)
        x = _MessagePassing(self.width)(x)
        for level in reversed(range(self.depth)):
            skip = skips[level]
            if x.shape[1] != skip.shape[1]:
                x = _unpool2(x)
            x = nn.Dense(self.width)(
                jnp.concatenate([x, skip], axis=-1)
            )
            x = _MessagePassing(self.width)(x)
        return nn.Dense(self.n_out)(x)


def _build(hp: GraphHyperparameters, n_out: int):
    if hp.architecture == "unet":
        return _GraphUNet(hp.width, hp.depth, n_out)
    if hp.architecture == "mpg":
        return _GraphMPG(hp.width, hp.depth, n_out)
    raise ValueError(f"unknown graph architecture {hp.architecture}")


@register("graph")
class GraphModel(Predictor):
    def __init__(self, input_variables, output_variables, widths_in,
                 widths_out, scaler_in, scaler_out, hp, params):
        super().__init__(input_variables, output_variables)
        self.widths_in = widths_in
        self.widths_out = widths_out
        self.scaler_in = scaler_in
        self.scaler_out = scaler_out
        self.hp = hp
        self.module = _build(hp, _num_channels(widths_out))
        self.params = params
        self._apply = jax.jit(
            lambda p, x: self.module.apply({"params": p}, x)
        )

    def predict(self, X):
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
            "hp": dataclasses.asdict(self.hp),
            "n_in": _num_channels(self.widths_in),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "GraphModel":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        hp = GraphHyperparameters(**meta["hp"])
        module = _build(hp, _num_channels(meta["widths_out"]))
        # parameter shapes are spatial-size independent
        params0 = module.init(
            jax.random.PRNGKey(0),
            jnp.zeros((6, 8, 8, meta["n_in"])),
        )["params"]
        flat0, unravel = jax.flatten_util.ravel_pytree(params0)
        flat = np.load(os.path.join(path, "params.npy"))
        return cls(
            meta["input_variables"], meta["output_variables"],
            meta["widths_in"], meta["widths_out"],
            StandardScaler.load_from(
                os.path.join(path, "scaler_in.npz")
            ),
            StandardScaler.load_from(
                os.path.join(path, "scaler_out.npz")
            ),
            hp, unravel(jnp.asarray(flat)),
        )


@register_training_function("graph", GraphHyperparameters)
def train_graph_model(
    hyperparameters: GraphHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
) -> GraphModel:
    hp = hyperparameters
    Xs, Ys = [], []
    for b in train_batches:
        x, widths_in = _stack_channels(b, input_variables)
        y, widths_out = _stack_channels(b, output_variables)
        Xs.append(x)
        Ys.append(y)
    X = np.concatenate(Xs)
    Y = np.concatenate(Ys)

    class _ChannelScaler(StandardScaler):
        def fit(self, A):
            self.mean = A.mean(axis=(0, 1, 2))
            self.std = A.std(axis=(0, 1, 2)) + self.std_epsilon
            return self

    scaler_in = _ChannelScaler().fit(X)
    scaler_out = _ChannelScaler().fit(Y)
    Xn = jnp.asarray(
        ((X - scaler_in.mean) / scaler_in.std), jnp.float32
    )
    Yn = jnp.asarray(
        ((Y - scaler_out.mean) / scaler_out.std), jnp.float32
    )

    module = _build(hp, Y.shape[-1])
    params = module.init(
        jax.random.PRNGKey(hp.seed), Xn[:6]
    )["params"]
    tx = optax.adam(hp.learning_rate)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, xb, yb):
        def loss_fn(p):
            return jnp.mean(
                (module.apply({"params": p}, xb) - yb) ** 2
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    n_cubes = X.shape[0] // 6
    for _ in range(hp.epochs):
        for c in range(n_cubes):
            params, opt_state, loss = step(
                params, opt_state,
                Xn[6 * c : 6 * (c + 1)], Yn[6 * c : 6 * (c + 1)],
            )
    return GraphModel(
        list(input_variables), list(output_variables), widths_in,
        widths_out, scaler_in, scaler_out, hp, params,
    )
