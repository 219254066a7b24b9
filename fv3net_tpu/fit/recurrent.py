"""Full-model-replacement recurrent trainer (the `fmr` training
function, reference fv3fit/pytorch/recurrent/train_fmr.py:446 — an RNN
that replaces the entire model step: given forcings and the current
state it predicts the next state, trained on time sequences).

Design: the reference steps a torch GRU per column in
Python; here the recurrence is a `lax.scan` over the time axis with
every cube column batched into one [6*y*x, features] matmul per gate —
the whole multi-step rollout (teacher-forced training AND free-running
prediction) is a single XLA program, gradients flow through the scan
(BPTT) via `jax.grad`.
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
)


@dataclasses.dataclass
class FMRHyperparameters:
    """(train_fmr.py FMRHyperparameters subset)"""

    hidden: int = 64
    epochs: int = 20
    learning_rate: float = 1e-3
    seed: int = 0
    train_rollout: int = 1  # steps of free-running in the loss


class _GRUCell(nn.Module):
    hidden: int

    @nn.compact
    def __call__(self, h, x):
        hx = jnp.concatenate([h, x], axis=-1)
        z = nn.sigmoid(nn.Dense(self.hidden)(hx))
        r = nn.sigmoid(nn.Dense(self.hidden)(hx))
        n = jnp.tanh(
            nn.Dense(self.hidden)(
                jnp.concatenate([r * h, x], axis=-1)
            )
        )
        return (1.0 - z) * n + z * h


class _FMRCore(nn.Module):
    """One model step: (hidden, state, forcing) -> (hidden, next state
    increment).  Columns are flattened to the batch axis upstream."""

    hidden: int
    n_state: int

    @nn.compact
    def __call__(self, h, state, forcing):
        x = nn.relu(
            nn.Dense(self.hidden)(
                jnp.concatenate([state, forcing], axis=-1)
            )
        )
        h = _GRUCell(self.hidden)(h, x)
        dstate = nn.Dense(self.n_state)(h)
        return h, state + dstate


@register("fmr")
class FMRModel(Predictor):
    """Predicts a whole trajectory: `predict_rollout(forcings, state0,
    n_steps)`; the Predictor.predict contract maps one step."""

    def __init__(self, input_variables, output_variables, widths_in,
                 widths_out, scaler_in, scaler_out, hp, params):
        super().__init__(input_variables, output_variables)
        self.widths_in = widths_in
        self.widths_out = widths_out
        self.scaler_in = scaler_in
        self.scaler_out = scaler_out
        self.hp = hp
        self.module = _FMRCore(hp.hidden, _num_channels(widths_out))
        self.params = params

        def rollout(p, state0, forcings):
            # state0 [cols, ns]; forcings [T, cols, nf]
            h0 = jnp.zeros(
                state0.shape[:-1] + (hp.hidden,), state0.dtype
            )

            def step(carry, f):
                h, s = carry
                h, s_next = self.module.apply({"params": p}, h, s, f)
                return (h, s_next), s_next

            _, traj = jax.lax.scan(step, (h0, state0), forcings)
            return traj

        self._rollout = jax.jit(rollout)

    def _norm_in(self, x):
        return (x - self.scaler_in.mean) / self.scaler_in.std

    def _norm_out(self, y):
        return (y - self.scaler_out.mean) / self.scaler_out.std

    def predict(self, X):
        """One step: forcing + current state (both read from X by
        name) -> next state."""
        from ..util.quantity import Quantity

        f, _ = _stack_channels(X, self.input_variables)
        s, _ = _stack_channels(X, self.output_variables)
        shp = f.shape[:-1]
        fn = self._norm_in(f).reshape(-1, f.shape[-1])
        sn = self._norm_out(s).reshape(-1, s.shape[-1])
        traj = np.asarray(
            self._rollout(
                self.params, jnp.asarray(sn, jnp.float32),
                jnp.asarray(fn, jnp.float32)[None],
            )
        )[0]
        y = (
            traj.reshape(shp + (traj.shape[-1],))
            * self.scaler_out.std + self.scaler_out.mean
        )
        return _unstack_channels(
            y, self.output_variables, self.widths_out
        )

    def predict_rollout(self, state0_np, forcings_np):
        """Free-running rollout: state0 [cols, ns] raw units, forcings
        [T, cols, nf] raw units -> [T, cols, ns] raw units."""
        sn = self._norm_out(state0_np)
        fn = self._norm_in(forcings_np)
        traj = np.asarray(
            self._rollout(
                self.params, jnp.asarray(sn, jnp.float32),
                jnp.asarray(fn, jnp.float32),
            )
        )
        return traj * self.scaler_out.std + self.scaler_out.mean

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
            "n_out": _num_channels(self.widths_out),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "FMRModel":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        hp = FMRHyperparameters(**meta["hp"])
        module = _FMRCore(hp.hidden, meta["n_out"])
        params0 = module.init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, hp.hidden)),
            jnp.zeros((1, meta["n_out"])),
            jnp.zeros((1, meta["n_in"])),
        )["params"]
        _, unravel = jax.flatten_util.ravel_pytree(params0)
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


@register_training_function("fmr", FMRHyperparameters)
def train_fmr_model(
    hyperparameters: FMRHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
) -> FMRModel:
    """train_batches: a TIME SERIES of states; input_variables are the
    forcings, output_variables the prognostic state the RNN replaces
    (train_fmr.py semantics)."""
    hp = hyperparameters
    series = list(train_batches)
    Fs, Ss = [], []
    for b in series:
        f, widths_in = _stack_channels(b, input_variables)
        s, widths_out = _stack_channels(b, output_variables)
        Fs.append(f)
        Ss.append(s)
    F = np.stack(Fs)  # [T, 6, y, x, nf]
    S = np.stack(Ss)  # [T, 6, y, x, ns]

    class _ChannelScaler(StandardScaler):
        def fit(self, A):
            self.mean = A.mean(axis=(0, 1, 2, 3))
            self.std = A.std(axis=(0, 1, 2, 3)) + self.std_epsilon
            return self

    scaler_in = _ChannelScaler().fit(F)
    scaler_out = _ChannelScaler().fit(S)
    Fn = ((F - scaler_in.mean) / scaler_in.std).astype(np.float32)
    Sn = ((S - scaler_out.mean) / scaler_out.std).astype(np.float32)
    T = F.shape[0]
    Fc = jnp.asarray(Fn.reshape(T, -1, F.shape[-1]))
    Sc = jnp.asarray(Sn.reshape(T, -1, S.shape[-1]))

    module = _FMRCore(hp.hidden, S.shape[-1])
    params = module.init(
        jax.random.PRNGKey(hp.seed),
        jnp.zeros((Fc.shape[1], hp.hidden)),
        Sc[0], Fc[0],
    )["params"]
    tx = optax.adam(hp.learning_rate)
    opt_state = tx.init(params)
    k = max(1, hp.train_rollout)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            h = jnp.zeros((Fc.shape[1], hp.hidden), Fc.dtype)
            total = 0.0
            s = Sc[0]
            # teacher forcing with k-step free-running segments (BPTT)
            for t in range(T - 1):
                if t % k == 0:
                    s = Sc[t]
                h, s = module.apply({"params": p}, h, s, Fc[t])
                total = total + jnp.mean((s - Sc[t + 1]) ** 2)
            return total / (T - 1)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    for _ in range(hp.epochs):
        params, opt_state, loss = step(params, opt_state)
    return FMRModel(
        list(input_variables), list(output_variables), widths_in,
        widths_out, scaler_in, scaler_out, hp, params,
    )
