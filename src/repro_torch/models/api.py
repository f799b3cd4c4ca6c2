"""Model construction (the public model API of the port)."""
from __future__ import annotations

from .transformer import DecoderLM


def build_model(cfg) -> DecoderLM:
    """The model for ``cfg``; ``family="dense"``, ``"ssm"`` and ``"hybrid"``
    are ported so far (the other families raise ``NotImplementedError``)."""
    return DecoderLM(cfg)
