"""The 10 assigned architectures — exact published dimensions.

The port's copy of ``repro/configs/archs.py``; sources are cited per config.
"""
from __future__ import annotations

from .base import (
    ArchConfig,
    EncoderConfig,
    MLAConfig,
    RGLRUConfig,
    SSMConfig,
    VisionStubConfig,
    register,
)

# --- dense LMs --------------------------------------------------------------

GEMMA_7B = register(ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, d_ff=24576,
    vocab_size=256000, head_dim=256,
    act="gelu", tie_embeddings=True, embed_scale=True, rms_plus_one=True,
    rope_theta=10000.0, train_microbatches=4,
    source="arXiv:2403.08295 (GeGLU, head_dim=256, MQA on 2b only)",
))

QWEN25_3B = register(ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab_size=151936, head_dim=128,
    qkv_bias=True, act="silu", tie_embeddings=True, rope_theta=1e6,
    train_microbatches=4,
    source="hf:Qwen/Qwen2.5 family (GQA kv=2, QKV bias)",
))

QWEN3_32B = register(ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab_size=151936, head_dim=128,
    qk_norm=True, act="silu", rope_theta=1e6, train_microbatches=8,
    source="hf:Qwen/Qwen3 family (qk_norm, GQA kv=8)",
))

QWEN15_4B = register(ArchConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
    vocab_size=151936, head_dim=128,
    qkv_bias=True, act="silu", rope_theta=5e6, train_microbatches=4,
    source="hf:Qwen/Qwen1.5 family (QKV bias, MHA)",
))

# --- VLM (backbone = mistral-7b; anyres frontend stubbed) -------------------

LLAVA_NEXT_MISTRAL_7B = register(ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128,
    act="silu", rope_theta=1e6, train_microbatches=4,
    vision=VisionStubConfig(n_image_tokens=2880),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (anyres tiling; frontend stub)",
))

# --- audio enc-dec (conv frontend stubbed) ----------------------------------

WHISPER_LARGE_V3 = register(ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab_size=51866, head_dim=64,
    act="gelu", learned_positions=True, norm_eps=1e-5, train_microbatches=4,
    max_position=32768,
    encoder=EncoderConfig(n_layers=32, n_ctx=1500),
    source="arXiv:2212.04356 (enc-dec; conv frontend stub provides frames)",
))

# --- MoE --------------------------------------------------------------------

DEEPSEEK_V3_671B = register(ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab_size=129280, head_dim=128,
    n_experts=256, experts_per_token=8, n_shared_experts=1, moe_d_ff=2048,
    first_dense_layers=3, act="silu", rope_theta=10000.0,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    train_microbatches=8, opt_state_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
    source="arXiv:2412.19437 (MLA, 1 shared + 256 routed top-8; MTP head "
           "omitted — see DESIGN.md)",
))

QWEN3_MOE_235B = register(ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab_size=151936, head_dim=128,
    n_experts=128, experts_per_token=8, moe_d_ff=1536,
    qk_norm=True, act="silu", rope_theta=1e6,
    train_microbatches=8, opt_state_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
    source="hf:Qwen/Qwen3-MoE family (128 experts top-8, qk_norm)",
))

# --- hybrid -----------------------------------------------------------------

RECURRENTGEMMA_9B = register(ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab_size=256000, head_dim=256,
    act="gelu", rms_plus_one=True, embed_scale=True, train_microbatches=4,
    rglru=RGLRUConfig(lru_width=4096, d_conv=4,
                      block_pattern=("rec", "rec", "attn"), attn_window=2048),
    source="arXiv:2402.19427 (Griffin: RG-LRU + local attn 1:2, MQA kv=1)",
))

# --- SSM --------------------------------------------------------------------

MAMBA2_130M = register(ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv_heads=24, d_ff=0,
    vocab_size=50280, head_dim=64, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    train_microbatches=8,
    source="arXiv:2405.21060 (SSD state-space duality; attn-free)",
))

ASSIGNED = [
    "gemma-7b", "qwen2.5-3b", "qwen3-32b", "qwen1.5-4b",
    "llava-next-mistral-7b", "whisper-large-v3",
    "deepseek-v3-671b", "qwen3-moe-235b-a22b",
    "recurrentgemma-9b", "mamba2-130m",
]
