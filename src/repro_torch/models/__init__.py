"""Model layer of the port (dense, moe, ssm and hybrid decoder families)."""
from .api import build_model  # noqa: F401
from .transformer import DecoderLM  # noqa: F401
