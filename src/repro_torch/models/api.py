"""Model construction (the public model API of the port): ``build_model``
and the vlm family's ``VLM``, the port of ``repro/models/api.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import PSpec
from .encdec import EncDecLM
from .transformer import DecoderLM, _proj

VISION_DIM = 1024    # CLIP-L hidden size (the stub frontend's output)


class VLM(DecoderLM):
    """LLaVA-NeXT: the dense backbone and a two-layer GeLU projector.

    The anyres vision tower is a stub, as in the JAX package: callers pass
    precomputed patch embeddings (B, P, ``VISION_DIM``); the projector and
    everything after it are real, trainable layers.  ``forward`` and
    ``prefill`` project extra embeddings whose last dim is ``VISION_DIM``
    (others are taken as already in the model's width); the serving engine
    takes text requests only, as the reference's does."""

    def param_specs(self) -> dict:
        specs = super().param_specs()
        d, dt = self.cfg.d_model, self.cfg.torch_dtype
        specs["mm_proj"] = {
            "w1": PSpec((VISION_DIM, d), dt),
            "b1": PSpec((d,), dt, "zeros"),
            "w2": PSpec((d, d), dt),
            "b2": PSpec((d,), dt, "zeros"),
        }
        return specs

    def project_patches(self, params, patches):
        """gelu_tanh(patches @ w1 + b1) @ w2 + b2 (``jax.nn.gelu``'s default
        is the tanh approximation)."""
        p = params["mm_proj"]
        h = F.gelu(_proj(patches.to(self.cfg.torch_dtype), p["w1"], p["b1"]),
                   approximate="tanh")
        return _proj(h, p["w2"], p["b2"])

    def _projected(self, params, extra_embeds):
        if extra_embeds is not None and extra_embeds.shape[-1] == VISION_DIM:
            return self.project_patches(params, extra_embeds)
        return extra_embeds

    def forward(self, params, tokens, impl: str = "xla", extra_embeds=None):
        return super().forward(params, tokens, impl, self._projected(params, extra_embeds))

    @torch.no_grad()
    def prefill(self, params, tokens, extra_embeds=None):
        return super().prefill(params, tokens, self._projected(params, extra_embeds))

    def loss(self, params, batch, impl: str = "xla"):
        """``DecoderLM.loss`` with the batch's ``patches`` as its extra
        embeddings: the text positions are scored."""
        batch = dict(batch)
        if "patches" in batch:
            batch["extra_embeds"] = batch.pop("patches")
        return super().loss(params, batch, impl)


def build_model(cfg):
    """The model for ``cfg``: an ``EncDecLM`` for the audio family, a
    ``VLM`` for the vlm family and a ``DecoderLM`` for the others."""
    if cfg.family == "audio":
        return EncDecLM(cfg)
    if cfg.family == "vlm":
        return VLM(cfg)
    return DecoderLM(cfg)
