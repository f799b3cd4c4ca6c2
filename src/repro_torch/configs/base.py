"""Architecture configuration schema + registry (the port's own copy).

The same fields, registry and ``reduced()`` numbers as
``repro/configs/base.py``, with a ``torch_dtype`` property in place of the
JAX dtype.  The port serves ``family="dense"``, ``"moe"`` (with MLA),
``"ssm"`` and ``"hybrid"``; the vlm and audio families' fields are kept so
every registered architecture loads.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD dims."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    factorized: bool = True

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent block dims."""

    lru_width: int = 4096
    d_conv: int = 4
    block_pattern: tuple[str, ...] = ("rec", "rec", "attn")
    attn_window: int = 2048


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (conv frontend stubbed)."""

    n_layers: int = 32
    n_ctx: int = 1500


@dataclass(frozen=True)
class VisionStubConfig:
    """LLaVA-NeXT anyres frontend stub: precomputed patch embeddings."""

    n_image_tokens: int = 2880
    image_every: int = 1


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    # attention flavor
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int | None = None
    learned_positions: bool = False
    max_position: int = 1 << 20
    # embedding / head
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma: x *= sqrt(d_model)
    rms_plus_one: bool = False        # gemma: (1 + w) RMSNorm weight
    act: str = "silu"
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int | None = None
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # family extensions
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    encoder: EncoderConfig | None = None
    vision: VisionStubConfig | None = None
    # numerics / execution (the execution knobs are the JAX package's; the
    # port reads dtype, attn_chunk, remat ("none" or "full") and
    # train_microbatches)
    dtype: str = "bfloat16"
    attn_chunk: int = 1024
    remat: str = "full"
    scan_layers: bool = True
    train_microbatches: int = 1
    opt_state_dtype: str = "float32"
    grad_accum_dtype: str = "float32"
    decode_cache_in_carry: bool = False
    decode_unroll_layers: bool = True
    # provenance
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128, as the JAX package lays out the
        embedding table."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def reduced(self) -> ArchConfig:
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else 3),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            max_position=4096,
            attn_chunk=64,
            remat="none",
        )
        if self.is_moe:
            kw.update(n_experts=4, experts_per_token=2, moe_d_ff=64,
                      first_dense_layers=min(self.first_dense_layers, 1))
        if self.mla:
            kw.update(mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                    qk_nope_head_dim=32, qk_rope_head_dim=16,
                                    v_head_dim=32))
        if self.ssm:
            kw.update(ssm=SSMConfig(d_state=16, d_conv=4, expand=2,
                                    head_dim=32, chunk=32))
        if self.rglru:
            kw.update(rglru=RGLRUConfig(lru_width=128, d_conv=4,
                                        block_pattern=("rec", "rec", "attn"),
                                        attn_window=64))
        if self.encoder:
            kw.update(encoder=EncoderConfig(n_layers=2, n_ctx=64))
        if self.vision:
            kw.update(vision=VisionStubConfig(n_image_tokens=16))
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    from . import archs  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> dict[str, ArchConfig]:
    from . import archs  # noqa: F401

    return dict(_REGISTRY)
