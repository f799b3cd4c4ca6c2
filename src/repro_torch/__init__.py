"""PyTorch/CUDA port of the serving path of ``repro`` (see README.md)."""
