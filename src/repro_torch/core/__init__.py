"""Core: the paper's ConvNet layer specs, zoo and layer-by-layer executor."""
