"""Generative model families: autoencoder + CycleGAN
(fv3fit/pytorch/cyclegan/train_autoencoder.py:66,
train_cyclegan.py:226 -- the reference trains these in torch; here
they are flax/optax so training itself runs jitted on the accelerator).

Both operate on cubed-sphere tiles packed channel-last
[batch*6, y, x, c] like the convolutional family.  The CycleGAN is the
reference's domain-translation tool (coarse <-> fine climate states):
two resnet generators G: A->B, F: B->A and two patch discriminators,
trained with LSGAN + cycle-consistency + identity losses.
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
from .convolutional import _stack_channels


class _Encoder(nn.Module):
    filters: int
    depth: int
    latent: int

    @nn.compact
    def __call__(self, x):
        for i in range(self.depth):
            x = nn.relu(
                nn.Conv(self.filters * 2 ** i, (3, 3), strides=(2, 2),
                        padding="SAME")(x)
            )
        return nn.Conv(self.latent, (1, 1))(x)


class _Decoder(nn.Module):
    filters: int
    depth: int
    n_out: int

    @nn.compact
    def __call__(self, z):
        for i in reversed(range(self.depth)):
            z = nn.relu(
                nn.ConvTranspose(
                    self.filters * 2 ** i, (3, 3), strides=(2, 2),
                    padding="SAME",
                )(z)
            )
        return nn.Conv(self.n_out, (1, 1))(z)


class _AE(nn.Module):
    filters: int
    depth: int
    latent: int
    n_out: int

    def setup(self):
        self.encoder = _Encoder(self.filters, self.depth, self.latent)
        self.decoder = _Decoder(self.filters, self.depth, self.n_out)

    def __call__(self, x):
        return self.decoder(self.encoder(x))


@dataclasses.dataclass
class AutoencoderHyperparameters:
    filters: int = 16
    depth: int = 2  # stride-2 stages; tile size must be divisible
    latent: int = 8
    epochs: int = 20
    learning_rate: float = 1e-3
    seed: int = 0


@register("autoencoder")
class AutoencoderModel(Predictor):
    def __init__(self, variables, widths, scaler, module, params):
        super().__init__(variables, variables)
        self.widths = widths
        self.scaler = scaler
        self.module = module
        self.params = params
        self._apply = jax.jit(
            lambda p, x: self.module.apply({"params": p}, x)
        )

    def encode(self, X):
        x, _ = _stack_channels(X, self.input_variables)
        xn = (x - self.scaler.mean) / self.scaler.std
        return np.asarray(
            jax.jit(
                lambda p, a: self.module.apply(
                    {"params": p}, a, method=lambda m, a: m.encoder(a)
                )
            )(self.params, jnp.asarray(xn, jnp.float32))
        )

    def predict(self, X):
        from ..util.quantity import Quantity

        x, _ = _stack_channels(X, self.input_variables)
        xn = (x - self.scaler.mean) / self.scaler.std
        yn = np.asarray(
            self._apply(self.params, jnp.asarray(xn, jnp.float32))
        )
        y = yn * self.scaler.std + self.scaler.mean
        out, i = {}, 0
        for name in self.output_variables:
            w = self.widths[name]
            block = y[..., i : i + w]
            i += w
            if w > 1:
                out[name] = Quantity(
                    np.moveaxis(block, -1, 1),
                    ("tile", "z", "y", "x"), "",
                )
            else:
                out[name] = Quantity(
                    block[..., 0], ("tile", "y", "x"), ""
                )
        return out

    def dump(self, path: str):
        self.scaler.dump(os.path.join(path, "scaler.npz"))
        flat, _ = jax.flatten_util.ravel_pytree(self.params)
        np.save(os.path.join(path, "params.npy"), np.asarray(flat))
        meta = {
            "input_variables": self.input_variables,
            "widths": self.widths,
            "filters": self.module.filters,
            "depth": self.module.depth,
            "latent": self.module.latent,
            "n_out": self.module.n_out,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        module = _AE(meta["filters"], meta["depth"], meta["latent"],
                     meta["n_out"])
        size = 4 * 2 ** meta["depth"]
        params0 = module.init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, size, size, meta["n_out"])),
        )["params"]
        _, unravel = jax.flatten_util.ravel_pytree(params0)
        flat = np.load(os.path.join(path, "params.npy"))
        return cls(
            meta["input_variables"], meta["widths"],
            StandardScaler.load_from(os.path.join(path, "scaler.npz")),
            module, unravel(jnp.asarray(flat)),
        )


@register_training_function("autoencoder", AutoencoderHyperparameters)
def train_autoencoder(
    hyperparameters: AutoencoderHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
) -> AutoencoderModel:
    hp = hyperparameters
    names = list(input_variables or output_variables)
    Xs = []
    widths = {}
    for b in train_batches:
        x, widths = _stack_channels(b, names)
        Xs.append(x)
    X = np.concatenate(Xs)

    class _ChannelScaler(StandardScaler):
        def fit(self, A):
            self.mean = A.mean(axis=(0, 1, 2))
            self.std = A.std(axis=(0, 1, 2)) + self.std_epsilon
            return self

    scaler = _ChannelScaler().fit(X)
    Xn = ((X - scaler.mean) / scaler.std).astype(np.float32)
    module = _AE(hp.filters, hp.depth, hp.latent, X.shape[-1])
    params = module.init(
        jax.random.PRNGKey(hp.seed), jnp.asarray(Xn[:1])
    )["params"]
    tx = optax.adam(hp.learning_rate)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, xb):
        def loss_fn(p):
            return jnp.mean(
                (module.apply({"params": p}, xb) - xb) ** 2
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    xb_all = jnp.asarray(Xn)
    for _ in range(hp.epochs):
        params, opt_state, loss = step(params, opt_state, xb_all)
    return AutoencoderModel(names, widths, scaler, module, params)


# --------------------------------------------------------------------------
# CycleGAN
# --------------------------------------------------------------------------


class _ResBlock(nn.Module):
    filters: int

    @nn.compact
    def __call__(self, x):
        h = nn.relu(nn.Conv(self.filters, (3, 3), padding="SAME")(x))
        h = nn.Conv(self.filters, (3, 3), padding="SAME")(h)
        return x + h


class _Generator(nn.Module):
    filters: int
    n_res: int
    n_out: int

    @nn.compact
    def __call__(self, x):
        h = nn.relu(nn.Conv(self.filters, (3, 3), padding="SAME")(x))
        for _ in range(self.n_res):
            h = _ResBlock(self.filters)(h)
        return nn.Conv(self.n_out, (3, 3), padding="SAME")(h)


class _Discriminator(nn.Module):
    filters: int

    @nn.compact
    def __call__(self, x):
        h = nn.leaky_relu(
            nn.Conv(self.filters, (4, 4), strides=(2, 2),
                    padding="SAME")(x), 0.2
        )
        h = nn.leaky_relu(
            nn.Conv(self.filters * 2, (4, 4), strides=(2, 2),
                    padding="SAME")(h), 0.2
        )
        return nn.Conv(1, (4, 4), padding="SAME")(h)  # patch outputs


@dataclasses.dataclass
class CycleGANHyperparameters:
    filters: int = 16
    n_res: int = 2
    epochs: int = 50
    learning_rate: float = 2e-4
    cycle_weight: float = 10.0
    identity_weight: float = 0.5
    seed: int = 0


@register("cyclegan")
class CycleGANModel(Predictor):
    """Domain translation A->B on cubed-sphere tiles; predict() maps
    the input variables (domain A) to the output names (domain B)."""

    def __init__(self, input_variables, output_variables, widths,
                 scaler_a, scaler_b, gen_ab, gen_ba, params_ab,
                 params_ba):
        super().__init__(input_variables, output_variables)
        self.widths = widths
        self.scaler_a = scaler_a
        self.scaler_b = scaler_b
        self.gen_ab = gen_ab
        self.gen_ba = gen_ba
        self.params_ab = params_ab
        self.params_ba = params_ba
        self._fwd = jax.jit(
            lambda p, x: self.gen_ab.apply({"params": p}, x)
        )
        self._bwd = jax.jit(
            lambda p, x: self.gen_ba.apply({"params": p}, x)
        )

    def predict(self, X):
        from ..util.quantity import Quantity

        x, _ = _stack_channels(X, self.input_variables)
        xn = (x - self.scaler_a.mean) / self.scaler_a.std
        yn = np.asarray(
            self._fwd(self.params_ab, jnp.asarray(xn, jnp.float32))
        )
        y = yn * self.scaler_b.std + self.scaler_b.mean
        out, i = {}, 0
        for name in self.output_variables:
            w = self.widths[name]
            block = y[..., i : i + w]
            i += w
            if w > 1:
                out[name] = Quantity(
                    np.moveaxis(block, -1, 1),
                    ("tile", "z", "y", "x"), "",
                )
            else:
                out[name] = Quantity(
                    block[..., 0], ("tile", "y", "x"), ""
                )
        return out

    def dump(self, path: str):
        self.scaler_a.dump(os.path.join(path, "scaler_a.npz"))
        self.scaler_b.dump(os.path.join(path, "scaler_b.npz"))
        for tag, params in (("ab", self.params_ab),
                            ("ba", self.params_ba)):
            flat, _ = jax.flatten_util.ravel_pytree(params)
            np.save(os.path.join(path, f"params_{tag}.npy"),
                    np.asarray(flat))
        meta = {
            "input_variables": self.input_variables,
            "output_variables": self.output_variables,
            "widths": self.widths,
            "filters": self.gen_ab.filters,
            "n_res": self.gen_ab.n_res,
            "n_out": self.gen_ab.n_out,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        gen = _Generator(meta["filters"], meta["n_res"], meta["n_out"])
        params0 = gen.init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, 8, 8, meta["n_out"])),
        )["params"]
        _, unravel = jax.flatten_util.ravel_pytree(params0)
        p_ab = unravel(
            jnp.asarray(np.load(os.path.join(path, "params_ab.npy")))
        )
        p_ba = unravel(
            jnp.asarray(np.load(os.path.join(path, "params_ba.npy")))
        )
        return cls(
            meta["input_variables"], meta["output_variables"],
            meta["widths"],
            StandardScaler.load_from(os.path.join(path, "scaler_a.npz")),
            StandardScaler.load_from(os.path.join(path, "scaler_b.npz")),
            gen, gen, p_ab, p_ba,
        )


@register_training_function("cyclegan", CycleGANHyperparameters)
def train_cyclegan(
    hyperparameters: CycleGANHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
) -> CycleGANModel:
    """train_batches: iterable of dicts holding BOTH domains' states;
    input_variables name domain A's fields, output_variables domain
    B's.  LSGAN objective with cycle + identity terms."""
    hp = hyperparameters
    As, Bs = [], []
    widths = {}
    for b in train_batches:
        a, _ = _stack_channels(b, input_variables)
        bb, widths = _stack_channels(b, output_variables)
        As.append(a)
        Bs.append(bb)
    A = np.concatenate(As)
    B = np.concatenate(Bs)
    if A.shape[-1] != B.shape[-1]:
        raise ValueError("cyclegan domains must share channel count")

    class _ChannelScaler(StandardScaler):
        def fit(self, Z):
            self.mean = Z.mean(axis=(0, 1, 2))
            self.std = Z.std(axis=(0, 1, 2)) + self.std_epsilon
            return self

    scaler_a = _ChannelScaler().fit(A)
    scaler_b = _ChannelScaler().fit(B)
    An = ((A - scaler_a.mean) / scaler_a.std).astype(np.float32)
    Bn = ((B - scaler_b.mean) / scaler_b.std).astype(np.float32)

    c = A.shape[-1]
    gen = _Generator(hp.filters, hp.n_res, c)
    disc = _Discriminator(hp.filters)
    key = jax.random.PRNGKey(hp.seed)
    ks = jax.random.split(key, 4)
    x0 = jnp.asarray(An[:1])
    g_ab = gen.init(ks[0], x0)["params"]
    g_ba = gen.init(ks[1], x0)["params"]
    d_a = disc.init(ks[2], x0)["params"]
    d_b = disc.init(ks[3], x0)["params"]

    tx_g = optax.adam(hp.learning_rate, b1=0.5)
    tx_d = optax.adam(hp.learning_rate, b1=0.5)
    gs = tx_g.init((g_ab, g_ba))
    ds = tx_d.init((d_a, d_b))

    def mse(x, y):
        return jnp.mean((x - y) ** 2)

    @jax.jit
    def g_step(g_params, d_params, gs, xa, xb):
        g_ab, g_ba = g_params
        d_a, d_b = d_params

        def loss_fn(gp):
            gab, gba = gp
            fake_b = gen.apply({"params": gab}, xa)
            fake_a = gen.apply({"params": gba}, xb)
            adv = mse(
                disc.apply({"params": d_b}, fake_b), 1.0
            ) + mse(disc.apply({"params": d_a}, fake_a), 1.0)
            cyc = mse(
                gen.apply({"params": gba}, fake_b), xa
            ) + mse(gen.apply({"params": gab}, fake_a), xb)
            idt = mse(
                gen.apply({"params": gab}, xb), xb
            ) + mse(gen.apply({"params": gba}, xa), xa)
            return (
                adv
                + hp.cycle_weight * cyc
                + hp.cycle_weight * hp.identity_weight * idt
            )

        loss, grads = jax.value_and_grad(loss_fn)(g_params)
        updates, gs = tx_g.update(grads, gs)
        return optax.apply_updates(g_params, updates), gs, loss

    @jax.jit
    def d_step(g_params, d_params, ds, xa, xb):
        g_ab, g_ba = g_params
        fake_b = gen.apply({"params": g_ab}, xa)
        fake_a = gen.apply({"params": g_ba}, xb)

        def loss_fn(dp):
            da, db = dp
            return (
                mse(disc.apply({"params": da}, xa), 1.0)
                + mse(disc.apply({"params": da}, fake_a), 0.0)
                + mse(disc.apply({"params": db}, xb), 1.0)
                + mse(disc.apply({"params": db}, fake_b), 0.0)
            )

        loss, grads = jax.value_and_grad(loss_fn)(d_params)
        updates, ds = tx_d.update(grads, ds)
        return optax.apply_updates(d_params, updates), ds, loss

    xa = jnp.asarray(An)
    xb = jnp.asarray(Bn)
    g_params = (g_ab, g_ba)
    d_params = (d_a, d_b)
    for _ in range(hp.epochs):
        g_params, gs, gl = g_step(g_params, d_params, gs, xa, xb)
        d_params, ds, dl = d_step(g_params, d_params, ds, xa, xb)
    return CycleGANModel(
        list(input_variables), list(output_variables), widths,
        scaler_a, scaler_b, gen, gen, g_params[0], g_params[1],
    )
