from importlib import import_module

from ._shared import (
    ArrayPacker,
    Predictor,
    StandardScaler,
    dump,
    load,
    register,
    TRAINING_FUNCTIONS,
    register_training_function,
    get_training_function,
    TrainingConfig,
)
from .models import (
    ConstantOutputPredictor,
    DerivedModel,
    EnsembleModel,
    CombinedOutputModel,
    OutOfSampleModel,
    TaperedModel,
)
from .dense import train_dense_model, DenseHyperparameters
from .reservoir import (
    train_reservoir_model,
    ReservoirHyperparameters,
    ReservoirComputingModel,
    Reservoir,
    RankDivider,
)
from .sklearn_models import (
    train_random_forest,
    RandomForestHyperparameters,
    MinMaxNoveltyDetector,
    train_min_max_novelty_detector,
)

# The flax-based families load on first use, so that the dense model --
# the one the coupled step traces in-graph -- needs no flax.
_LAZY = {
    "train_convolutional_model": "convolutional",
    "ConvolutionalHyperparameters": "convolutional",
    "ConvolutionalModel": "convolutional",
    "append_halos": "convolutional",
    "train_precipitative_model": "precipitative",
    "PrecipitativeHyperparameters": "precipitative",
    "PrecipitativeModel": "precipitative",
    "train_autoencoder": "generative",
    "AutoencoderHyperparameters": "generative",
    "AutoencoderModel": "generative",
    "train_cyclegan": "generative",
    "CycleGANHyperparameters": "generative",
    "CycleGANModel": "generative",
    "train_graph_model": "graph",
    "GraphHyperparameters": "graph",
    "GraphModel": "graph",
    "train_fmr_model": "recurrent",
    "FMRHyperparameters": "recurrent",
    "FMRModel": "recurrent",
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(f".{_LAZY[name]}", __name__), name)


__all__ = [
    "ArrayPacker",
    "Predictor",
    "StandardScaler",
    "dump",
    "load",
    "register",
    "TRAINING_FUNCTIONS",
    "register_training_function",
    "get_training_function",
    "TrainingConfig",
    "ConstantOutputPredictor",
    "DerivedModel",
    "EnsembleModel",
    "CombinedOutputModel",
    "OutOfSampleModel",
    "TaperedModel",
    "train_dense_model",
    "DenseHyperparameters",
    "train_reservoir_model",
    "ReservoirHyperparameters",
    "ReservoirComputingModel",
    "Reservoir",
    "RankDivider",
    "train_random_forest",
    "RandomForestHyperparameters",
    "MinMaxNoveltyDetector",
    "train_min_max_novelty_detector",
    *_LAZY,
]
