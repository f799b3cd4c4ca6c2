"""Model layer of the port (dense and ssm decoder families)."""
from .api import build_model  # noqa: F401
from .transformer import DecoderLM  # noqa: F401
