"""Model construction (the public model API of the port)."""
from __future__ import annotations

from .transformer import DecoderLM


def build_model(cfg) -> DecoderLM:
    """The model for ``cfg``; ``family="dense"``, ``"moe"``, ``"ssm"`` and
    ``"hybrid"`` are ported so far (vlm and audio raise
    ``NotImplementedError``)."""
    return DecoderLM(cfg)
