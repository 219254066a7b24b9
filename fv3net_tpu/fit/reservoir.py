"""Reservoir computing (fv3fit/reservoir: reservoir.py:31-123,
domain.py:19-129, readout.py, model.py:5).

Redesign: the reference builds scipy.sparse W_in/W_res and steps them
per subdomain in numpy; here the reservoir matrices are dense (masked
random) jnp arrays -- at reservoir sizes O(10^3) a dense matvec is the
accelerator's natural shape -- and the update
is vmapped over all subdomains at once, so one training step is a
single [n_subdomains, state, state] batched matmul.  The readout is a
closed-form ridge regression solved on device.

Components:
  * Reservoir        -- leaky echo-state update x' = (1-a) x + a tanh(
                        W_res x + W_in u)
  * RankDivider      -- split each tile into overlapping subdomains
                        (domain.py:19): inputs see overlap halos,
                        outputs write the interior
  * LinearReadout    -- ridge-regressed output map with optional
                        quadratic (x, x^2) features
  * ReservoirComputingModel -- Predictor with persistent reservoir
                        state: synchronize on a burn-in series, then
                        predict increments
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ._shared import Predictor, register, register_training_function


@dataclasses.dataclass
class ReservoirHyperparameters:
    """(fv3fit/reservoir/config.py subset)"""

    state_size: int = 512
    adjacency_sparsity: float = 0.95  # fraction of W_res zeros
    spectral_radius: float = 0.6
    input_scaling: float = 0.5
    leakage: float = 0.5  # alpha
    ridge: float = 1.0e-6
    quadratic_features: bool = True
    subdomain_layout: Sequence[int] = (2, 2)
    overlap: int = 1
    burn_in: int = 10
    seed: int = 0


class RankDivider:
    """Split [ny, nx] into layout[0] x layout[1] overlapping subdomains
    (fv3fit/reservoir/domain.py:19-129).  Input views include `overlap`
    halo cells (clipped at tile edges); output views are the interior
    partition."""

    def __init__(self, layout, ny, nx, overlap):
        self.layout = tuple(layout)
        self.ny, self.nx = ny, nx
        self.overlap = overlap
        if ny % layout[0] or nx % layout[1]:
            raise ValueError("layout must evenly divide the tile")
        self.sub_ny = ny // layout[0]
        self.sub_nx = nx // layout[1]
        self._views = []
        for jy in range(layout[0]):
            for jx in range(layout[1]):
                y0, y1 = jy * self.sub_ny, (jy + 1) * self.sub_ny
                x0, x1 = jx * self.sub_nx, (jx + 1) * self.sub_nx
                yo0, yo1 = max(0, y0 - overlap), min(ny, y1 + overlap)
                xo0, xo1 = max(0, x0 - overlap), min(nx, x1 + overlap)
                self._views.append(
                    ((y0, y1, x0, x1), (yo0, yo1, xo0, xo1))
                )

    @property
    def n_subdomains(self):
        return self.layout[0] * self.layout[1]

    def subdomains_with_overlap(self, field: np.ndarray) -> np.ndarray:
        """field [..., ny, nx] -> [n_sub, ..., flat_features] (features
        = padded overlap window; edge windows are edge-padded so every
        subdomain has equal feature count)."""
        ow_y = self.sub_ny + 2 * self.overlap
        ow_x = self.sub_nx + 2 * self.overlap
        padded = np.pad(
            field,
            [(0, 0)] * (field.ndim - 2)
            + [(self.overlap, self.overlap)] * 2,
            mode="edge",
        )
        out = []
        for (y0, y1, x0, x1), _ in self._views:
            win = padded[..., y0 : y0 + ow_y, x0 : x0 + ow_x]
            out.append(win.reshape(win.shape[:-2] + (-1,)))
        return np.stack(out)

    def merge_subdomains(self, blocks: np.ndarray) -> np.ndarray:
        """[n_sub, ..., sub_ny*sub_nx] -> [..., ny, nx] interiors."""
        out = np.zeros(
            blocks.shape[1:-1] + (self.ny, self.nx), blocks.dtype
        )
        for i, ((y0, y1, x0, x1), _) in enumerate(self._views):
            out[..., y0:y1, x0:x1] = blocks[i].reshape(
                blocks.shape[1:-1] + (self.sub_ny, self.sub_nx)
            )
        return out


class Reservoir:
    """Leaky echo-state network core (fv3fit/reservoir/reservoir.py:31).

    W_res is a masked dense random matrix rescaled to the requested
    spectral radius; increment_state is pure and vmappable."""

    def __init__(self, hp: ReservoirHyperparameters, n_input: int):
        self.hp = hp
        key = jax.random.PRNGKey(hp.seed)
        k1, k2, k3 = jax.random.split(key, 3)
        w = jax.random.normal(k1, (hp.state_size, hp.state_size))
        mask = (
            jax.random.uniform(k2, w.shape) > hp.adjacency_sparsity
        )
        w = w * mask
        # spectral radius on host (a non-symmetric eig; this is a
        # one-time setup cost on a [state, state] matrix)
        eigmax = float(
            np.abs(np.linalg.eigvals(np.asarray(w, np.float64))).max()
        )
        self.W_res = jnp.asarray(
            w * (hp.spectral_radius / max(eigmax, 1e-12)), jnp.float32
        )
        self.W_in = jnp.asarray(
            hp.input_scaling
            * jax.random.uniform(
                k3, (hp.state_size, n_input), minval=-1.0, maxval=1.0
            ),
            jnp.float32,
        )
        self.n_input = n_input

    def increment_state(self, u, x):
        """u [..., n_input], x [..., state] -> new x."""
        a = self.hp.leakage
        pre = u @ self.W_in.T + x @ self.W_res.T
        return (1.0 - a) * x + a * jnp.tanh(pre)


def _readout_features(x, quadratic: bool):
    return jnp.concatenate([x, x * x], axis=-1) if quadratic else x


def ridge_fit(S, Y, lam):
    """W minimizing ||S W - Y||^2 + lam ||W||^2, on device."""
    n = S.shape[1]
    A = S.T @ S + lam * jnp.eye(n, dtype=S.dtype)
    B = S.T @ Y
    return jnp.linalg.solve(A, B)


@register("reservoir")
class ReservoirComputingModel(Predictor):
    """(fv3fit/reservoir/model.py:5): stateful predictor -- call
    `synchronize(series)` on a burn-in window, then `predict(state)`
    advances the reservoir one step and returns the readout."""

    def __init__(self, input_variables, output_variables, hp,
                 reservoir: Reservoir, W_out, divider: RankDivider,
                 norm_in, norm_out):
        super().__init__(input_variables, output_variables)
        self.hp = hp
        self.reservoir = reservoir
        self.W_out = W_out
        self.divider = divider
        self.norm_in = norm_in  # (mean, std) over features
        self.norm_out = norm_out
        self.reset()
        self._step = jax.jit(
            lambda u, x: self.reservoir.increment_state(u, x)
        )

    def reset(self):
        self._x = jnp.zeros(
            (6 * self.divider.n_subdomains, self.hp.state_size),
            jnp.float32,
        )

    def _pack_inputs(self, X) -> np.ndarray:
        fields = [np.asarray(X[n].values, np.float32)
                  for n in self.input_variables]
        stacked = np.concatenate(
            [f[:, None] if f.ndim == 3 else f for f in fields], axis=1
        )  # [6, c, y, x]
        subs = self.divider.subdomains_with_overlap(stacked)
        # [n_sub, 6, c*feat] -> [6*n_sub, features]
        subs = np.moveaxis(subs, 1, 0).reshape(
            6 * self.divider.n_subdomains, -1
        )
        return (subs - self.norm_in[0]) / self.norm_in[1]

    def increment(self, X):
        u = jnp.asarray(self._pack_inputs(X))
        self._x = self._step(u, self._x)

    def synchronize(self, series):
        self.reset()
        for X in series:
            self.increment(X)

    def predict(self, X):
        from ..util.quantity import Quantity

        self.increment(X)
        feats = _readout_features(
            self._x, self.hp.quadratic_features
        )
        yn = np.asarray(feats @ self.W_out)
        y = yn * self.norm_out[1] + self.norm_out[0]
        # unpack per-variable interiors
        out = {}
        nz_off = 0
        sub_feat = self.divider.sub_ny * self.divider.sub_nx
        y = y.reshape(6, self.divider.n_subdomains, -1)
        y = np.moveaxis(y, 1, 0)  # [n_sub, 6, out_features]
        for name in self.output_variables:
            width = self._out_widths[name]
            block = y[..., nz_off : nz_off + width * sub_feat]
            nz_off += width * sub_feat
            block = block.reshape(
                self.divider.n_subdomains, 6, width, sub_feat
            )
            merged = self.divider.merge_subdomains(block)
            if width == 1:
                out[name] = Quantity(
                    merged[:, 0], ("tile", "y", "x"), ""
                )
            else:
                out[name] = Quantity(
                    merged, ("tile", "z", "y", "x"), ""
                )
        return out

    def dump(self, path: str):
        np.savez(
            os.path.join(path, "arrays.npz"),
            W_res=np.asarray(self.reservoir.W_res),
            W_in=np.asarray(self.reservoir.W_in),
            W_out=np.asarray(self.W_out),
            mean_in=self.norm_in[0], std_in=self.norm_in[1],
            mean_out=self.norm_out[0], std_out=self.norm_out[1],
        )
        meta = {
            "input_variables": self.input_variables,
            "output_variables": self.output_variables,
            "hp": dataclasses.asdict(self.hp),
            "ny": self.divider.ny, "nx": self.divider.nx,
            "out_widths": self._out_widths,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "ReservoirComputingModel":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        hp_d = dict(meta["hp"])
        hp_d["subdomain_layout"] = tuple(hp_d["subdomain_layout"])
        hp = ReservoirHyperparameters(**hp_d)
        arrays = np.load(os.path.join(path, "arrays.npz"))
        divider = RankDivider(
            hp.subdomain_layout, meta["ny"], meta["nx"], hp.overlap
        )
        res = Reservoir.__new__(Reservoir)
        res.hp = hp
        res.W_res = jnp.asarray(arrays["W_res"])
        res.W_in = jnp.asarray(arrays["W_in"])
        res.n_input = res.W_in.shape[1]
        model = cls(
            meta["input_variables"], meta["output_variables"], hp, res,
            jnp.asarray(arrays["W_out"]), divider,
            (arrays["mean_in"], arrays["std_in"]),
            (arrays["mean_out"], arrays["std_out"]),
        )
        model._out_widths = {
            k: int(v) for k, v in meta["out_widths"].items()
        }
        return model


@register_training_function("reservoir", ReservoirHyperparameters)
def train_reservoir_model(
    hyperparameters: ReservoirHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
) -> ReservoirComputingModel:
    """train_batches: a TIME SERIES of states (each a State dict); the
    model learns to map reservoir(u_t) -> y_{t+1} interiors."""
    hp = hyperparameters
    series = list(train_batches)
    first = series[0]
    ref = np.asarray(first[input_variables[0]].values)
    ny, nx = ref.shape[-2], ref.shape[-1]
    divider = RankDivider(hp.subdomain_layout, ny, nx, hp.overlap)

    def pack_in(X):
        fields = [np.asarray(X[n].values, np.float32)
                  for n in input_variables]
        stacked = np.concatenate(
            [f[:, None] if f.ndim == 3 else f for f in fields], axis=1
        )
        subs = divider.subdomains_with_overlap(stacked)
        return np.moveaxis(subs, 1, 0).reshape(
            6 * divider.n_subdomains, -1
        )

    out_widths = {}

    def pack_out(X):
        blocks = []
        for n in output_variables:
            f = np.asarray(X[n].values, np.float32)
            if f.ndim == 3:
                f = f[:, None]
            out_widths[n] = f.shape[1]
            # interiors without overlap: reuse divider with overlap=0
            d0 = RankDivider(hp.subdomain_layout, ny, nx, 0)
            subs = d0.subdomains_with_overlap(f)
            blocks.append(
                np.moveaxis(subs, 1, 0).reshape(
                    6, divider.n_subdomains, -1
                )
            )
        cat = np.concatenate(blocks, axis=-1)
        return cat.reshape(6 * divider.n_subdomains, -1)

    U = np.stack([pack_in(X) for X in series])  # [T, B, n_in]
    Yall = np.stack([pack_out(X) for X in series])
    mean_in = U.mean(axis=(0, 1))
    std_in = U.std(axis=(0, 1)) + 1e-8
    mean_out = Yall.mean(axis=(0, 1))
    std_out = Yall.std(axis=(0, 1)) + 1e-8
    Un = ((U - mean_in) / std_in).astype(np.float32)
    Yn = ((Yall - mean_out) / std_out).astype(np.float32)

    reservoir = Reservoir(hp, Un.shape[-1])

    def scan_fn(x, u):
        x2 = reservoir.increment_state(u, x)
        return x2, x2

    x0 = jnp.zeros(
        (Un.shape[1], hp.state_size), jnp.float32
    )
    _, states = jax.lax.scan(scan_fn, x0, jnp.asarray(Un))
    # state at step t pairs with target at step t+1
    t0 = hp.burn_in
    S = _readout_features(
        states[t0:-1].reshape(-1, hp.state_size),
        hp.quadratic_features,
    )
    Y = jnp.asarray(Yn[t0 + 1 :].reshape(-1, Yn.shape[-1]))
    W_out = ridge_fit(S, Y, hp.ridge)
    model = ReservoirComputingModel(
        list(input_variables), list(output_variables), hp, reservoir,
        W_out, divider, (mean_in, std_in), (mean_out, std_out),
    )
    model._out_widths = out_widths
    return model
