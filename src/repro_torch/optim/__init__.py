"""Optimizers of the port (sgd and momentum through the stream_gd kernel)."""
from .optimizer import Optimizer, adamw, get_optimizer, momentum, sgd  # noqa: F401
