"""Deployment surface (the JAX package's ``inference/``): ``Config``,
the serving precisions, the ``Predictor`` with its ZeroCopy-style
handles and bucketed generation mode, and benchmarking."""
from .benchmark import Benchmark, device_time_per_run  # noqa: F401
from .config import Config, PrecisionType  # noqa: F401
from .precision import ServingParams, serving_params  # noqa: F401
from .predictor import (InferTensor, Predictor,  # noqa: F401
                        create_predictor)
