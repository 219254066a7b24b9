"""ML framework core abstractions (fv3fit/_shared equivalents).

Predictor ABC (predictor.py:44-93), the io registry + dump/load
(io.py:17-92, a `name` file in each model directory selects the class),
the training-function registry (training_config.py:125-151), array
packing to (sample, feature) (stacking.py/packer.py), and scalers
(scaler.py).  State here is the framework's Quantity-dict instead of
xarray Datasets; semantics are otherwise unchanged.
"""

from __future__ import annotations

import abc
import dataclasses
import importlib
import json
import os
from typing import Callable, Dict, Iterable, Mapping, Sequence

import numpy as np

import jax.numpy as jnp

from ..util.quantity import Quantity

State = Mapping[str, Quantity]

_IO_REGISTRY: Dict[str, type] = {}
_NAME_FILE = "name"
TRAINING_FUNCTIONS: Dict[str, Callable] = {}

# families whose modules register themselves on import but are not
# imported with the package (they need flax); a registry miss loads them
_LAZY_FAMILIES = (
    "convolutional", "precipitative", "generative", "graph",
    "recurrent", "transformed",
)


def _lookup(table: Dict, name: str):
    if name not in table:
        for module in _LAZY_FAMILIES:
            importlib.import_module(f"{__package__}.{module}")
    return table[name]


class Predictor(abc.ABC):
    """The prediction contract (fv3fit/_shared/predictor.py:44)."""

    def __init__(
        self,
        input_variables: Iterable[str],
        output_variables: Iterable[str],
    ):
        self.input_variables = list(input_variables)
        self.output_variables = list(output_variables)

    @abc.abstractmethod
    def predict(self, X: State) -> State:
        ...

    def dump(self, path: str) -> None:
        raise NotImplementedError

    @classmethod
    def load(cls, path: str) -> "Predictor":
        raise NotImplementedError


def register(name: str):
    """Class decorator adding the model type to the io registry
    (io.py:17)."""

    def wrap(cls):
        _IO_REGISTRY[name] = cls
        cls._io_name = name
        return cls

    return wrap


def dump(model, path: str) -> None:
    """(io.py:92)"""
    os.makedirs(path, exist_ok=True)
    name = getattr(model, "_io_name", None)
    if name is None:
        raise ValueError(
            f"{type(model).__name__} is not registered for io"
        )
    with open(os.path.join(path, _NAME_FILE), "w") as f:
        f.write(name)
    model.dump(path)


def load(path: str):
    """(io.py:71)"""
    with open(os.path.join(path, _NAME_FILE)) as f:
        name = f.read().strip()
    return _lookup(_IO_REGISTRY, name).load(path)


def register_training_function(name: str, hyperparameter_class=None):
    """(training_config.py:136)"""

    def wrap(fn):
        TRAINING_FUNCTIONS[name] = (fn, hyperparameter_class)
        return fn

    return wrap


def get_training_function(name: str):
    return _lookup(TRAINING_FUNCTIONS, name)[0]


def get_hyperparameter_class(name: str):
    return _lookup(TRAINING_FUNCTIONS, name)[1]


@dataclasses.dataclass
class TrainingConfig:
    """(training_config.py)"""

    model_type: str
    hyperparameters: dict = dataclasses.field(default_factory=dict)
    input_variables: Sequence[str] = ()
    output_variables: Sequence[str] = ()

    @classmethod
    def from_dict(cls, d: Mapping) -> "TrainingConfig":
        return cls(
            model_type=d["model_type"],
            hyperparameters=dict(d.get("hyperparameters", {})),
            input_variables=list(d.get("input_variables", [])),
            output_variables=list(d.get("output_variables", [])),
        )


class ArrayPacker:
    """Stack named fields into a (sample, feature) matrix and back
    (fv3fit/_shared/packer.py:45; stacking.py:12).

    3D fields [tile, z, y, x] become per-column feature blocks of width
    nz; 2D fields contribute one feature.  Samples are all columns.
    """

    def __init__(self, names: Sequence[str]):
        self.names = list(names)
        self._feature_counts: Dict[str, int] = {}

    def to_array(self, state: State) -> np.ndarray:
        # namespace-preserving: jax-array states stay on DEVICE (the
        # coupled hot path must not round-trip full fields through the
        # host), numpy states stay numpy (sklearn trainers need real
        # ndarrays)
        import jax as _jax

        blocks = []
        any_jax = False
        for name in self.names:
            q = state[name]
            arr = q.values
            if isinstance(arr, _jax.Array):
                any_jax = True
                xp = jnp
            else:
                arr = np.asarray(arr)
                xp = np
            if arr.ndim == 4:  # [tile, z, y, x]
                nz = arr.shape[1]
                block = xp.moveaxis(arr, 1, -1).reshape(-1, nz)
            elif arr.ndim == 3:  # [tile, y, x]
                block = arr.reshape(-1, 1)
            elif arr.ndim == 2:  # already [sample, feature]
                block = arr
            else:
                raise ValueError(f"bad rank for {name}: {arr.shape}")
            self._feature_counts[name] = block.shape[1]
            blocks.append(block)
        xp = jnp if any_jax else np
        return xp.concatenate(blocks, axis=1)

    def to_state(
        self, array: np.ndarray, template: State
    ) -> Dict[str, Quantity]:
        out = {}
        i = 0
        for name in self.names:
            width = self._feature_counts[name]
            block = array[:, i : i + width]
            i += width
            tq = template[name]
            tshape = tq.shape
            if len(tshape) == 4:
                arr = block.reshape(
                    tshape[0], tshape[2], tshape[3], tshape[1]
                )
                import jax as _jax

                xp = jnp if isinstance(arr, _jax.Array) else np
                arr = xp.moveaxis(arr, -1, 1)
            elif len(tshape) == 3:
                arr = block.reshape(tshape)
            else:
                arr = block
            out[name] = tq.with_data(arr)
        return out

    def feature_count(self) -> int:
        return sum(self._feature_counts.values())

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(
                {"names": self.names,
                 "feature_counts": self._feature_counts}, f
            )

    @classmethod
    def load_from(cls, path: str) -> "ArrayPacker":
        with open(path) as f:
            d = json.load(f)
        p = cls(d["names"])
        p._feature_counts = {
            k: int(v) for k, v in d["feature_counts"].items()
        }
        return p


class StandardScaler:
    """(fv3fit/_shared/scaler.py)"""

    def __init__(self, std_epsilon: float = 1e-12):
        self.mean = None
        self.std = None
        self.std_epsilon = std_epsilon

    def fit(self, X: np.ndarray):
        self.mean = X.mean(axis=0)
        self.std = X.std(axis=0) + self.std_epsilon
        return self

    def normalize(self, X):
        return (X - self.mean) / self.std

    def denormalize(self, X):
        return X * self.std + self.mean

    def dump(self, path: str):
        np.savez(path, mean=self.mean, std=self.std)

    @classmethod
    def load_from(cls, path: str) -> "StandardScaler":
        d = np.load(path)
        s = cls()
        s.mean = d["mean"]
        s.std = d["std"]
        return s
