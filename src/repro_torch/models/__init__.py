"""Model layer of the port: the decoder-only families (dense, moe, ssm,
hybrid), the vlm (``VLM``) and the audio encoder/decoder (``EncDecLM``)."""
from .api import VLM, build_model  # noqa: F401
from .encdec import EncDecLM  # noqa: F401
from .transformer import DecoderLM  # noqa: F401
