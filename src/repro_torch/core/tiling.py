"""Layer and tile descriptors of the paper's 4D tiling (section IV-A).

``ConvLayerSpec`` describes one CONV, FC-as-conv or POOL layer;
``Tile4D`` is the paper's ``(T_Xi, T_Yi, T_Ci, T_Co)`` tile of one layer.
Both are plain Python, the same fields and properties as
``repro/core/tiling.py``; the port keeps its own copy so that it imports
nothing of the JAX package.  The tile optimizer and the block choosers of
that module are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ConvLayerSpec:
    """One CONV (or FC-as-1x1-conv, or POOL) layer of a ConvNet."""

    name: str
    xi: int          # input width
    yi: int          # input height
    ci: int          # input channels
    co: int          # output channels
    kx: int = 3
    ky: int = 3
    sx: int = 1      # stride
    sy: int = 1
    px: int = 0      # zero padding (symmetric)
    py: int = 0
    kind: str = "conv"   # conv | pool | fc
    act: bool = True     # fused activation (ReLU) after the layer

    @property
    def xo(self) -> int:
        return (self.xi + 2 * self.px - self.kx) // self.sx + 1

    @property
    def yo(self) -> int:
        return (self.yi + 2 * self.py - self.ky) // self.sy + 1

    @property
    def macs(self) -> int:
        """MAC count for the full layer (pooling counted as 1 op/elem)."""
        if self.kind == "pool":
            return self.xo * self.yo * self.co * self.kx * self.ky
        return self.xo * self.yo * self.co * self.kx * self.ky * self.ci

    @property
    def flops(self) -> int:
        return 2 * self.macs

    @property
    def in_bytes(self) -> int:
        return 4 * self.xi * self.yi * self.ci

    @property
    def out_bytes(self) -> int:
        return 4 * self.xo * self.yo * self.co

    @property
    def coeff_bytes(self) -> int:
        if self.kind == "pool":
            return 0
        return 4 * self.kx * self.ky * self.ci * self.co


@dataclass(frozen=True)
class Tile4D:
    """The paper's ``(T_Xi, T_Yi, T_Ci, T_Co)`` tuple for a given layer."""

    txi: int
    tyi: int
    tci: int
    tco: int

    def txo(self, l: ConvLayerSpec) -> int:
        return max(1, (self.txi - l.kx) // l.sx + 1)

    def tyo(self, l: ConvLayerSpec) -> int:
        return max(1, (self.tyi - l.ky) // l.sy + 1)

    def r_tcl(self) -> float:
        """Tile channel ratio R_TCL = T_Co / T_Ci  (OI is proportional to it)."""
        return self.tco / self.tci
