"""4D tiling, the paper's core scheduling contribution (section IV-A): the
port of ``repro/core/tiling.py``.

``ConvLayerSpec`` describes one CONV, FC-as-conv or POOL layer;
``Tile4D`` is the paper's ``(T_Xi, T_Yi, T_Ci, T_Co)`` tile of one layer.
The offline optimizer (``tile_candidates``, ``optimize_tile``) searches
tile shapes under the scratchpad's capacity with ping-pong buffering and
picks the fastest under a machine model (``core.smc.SMCModel``), then the
least DRAM traffic among tiles within a small slack of it;
``oi_for_tiles`` gives a tiling's operational intensity.  All of it is
plain Python with the same fields, properties and arithmetic as the JAX
package's module; the port keeps its own copy so that it imports nothing
of that package.  The TPU block choosers there (``VMemBudget``,
``choose_matmul_blocks``, ``choose_conv_blocks``) size Pallas VMEM blocks
and have no counterpart: on the card that job belongs to a tuning registry.
"""
from __future__ import annotations

import math
from collections.abc import Iterator
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


@dataclass(frozen=True)
class TilePerf:
    """Modeled execution of one layer under one tile choice (§VI-A model)."""

    tile: Tile4D
    n_tiles: int             # output tiles in the layer
    macs: int                # total layer MACs
    dram_read_bytes: int
    dram_write_bytes: int
    compute_cycles: float    # per-cluster cycles, all tiles, incl. overheads
    dma_cycles: float
    total_cycles: float      # with ping-pong overlap + sync
    oi: float                # operational intensity (FLOPs / DRAM byte)
    spm_bytes: int

    @property
    def gflops(self) -> float:
        # at the machine's clock; filled by the simulator via cycles→time
        return float("nan")


# ---------------------------------------------------------------------------
# Capacity accounting
# ---------------------------------------------------------------------------


def tile_spm_bytes(l: ConvLayerSpec, t: Tile4D, ping_pong: bool = True) -> int:
    """Scratchpad bytes needed to hold one in-flight tile set.

    Input tile (augmented: halos included — §IV-A "tile overlapping"),
    output tile (partial sums resident until all T_Ci passes finish), and the
    coefficient block.  Ping-pong doubles the *streaming* buffers (input +
    coeffs) but not the resident output accumulator.
    """
    in_b = 4 * t.txi * t.tyi * t.tci
    out_b = 4 * t.txo(l) * t.tyo(l) * t.tco
    coef_b = 0 if l.kind == "pool" else 4 * l.kx * l.ky * t.tci * t.tco
    if ping_pong:
        return 2 * (in_b + coef_b) + out_b
    return in_b + coef_b + out_b


def augmented_tile_overhead(l: ConvLayerSpec, t: Tile4D) -> float:
    """Fractional DRAM storage overhead of augmented tiles (halo duplication).

    The paper reports <3% on average for well-chosen tiles.
    """
    if l.kx <= 1 and l.ky <= 1:
        return 0.0
    raw = t.txo(l) * l.sx * t.tyo(l) * l.sy
    aug = t.txi * t.tyi
    return max(0.0, aug / max(raw, 1) - 1.0)


# ---------------------------------------------------------------------------
# Candidate enumeration + optimizer
# ---------------------------------------------------------------------------


def _divisor_like(n: int, lo: int = 1) -> list[int]:
    """Candidate tile extents for a dimension of size n: powers of two and
    exact divisors, clipped to n (keeps the search cheap but expressive)."""
    cands: set[int] = {n}
    v = lo
    while v < n:
        cands.add(v)
        v *= 2
    for d in (3, 5, 7, 14, 28, 56, 112):
        if d <= n:
            cands.add(d)
    return sorted(c for c in cands if lo <= c <= n)


def tile_candidates(
    l: ConvLayerSpec,
    spm_limit: int,
    max_candidates: int = 4096,
) -> Iterator[Tile4D]:
    """Enumerate feasible tiles for layer ``l`` under a scratchpad budget."""
    n = 0
    xo_c = _divisor_like(l.xo)
    yo_c = _divisor_like(l.yo)
    ci_c = _divisor_like(l.ci)
    co_c = _divisor_like(l.co)
    for txo in xo_c:
        txi = (txo - 1) * l.sx + l.kx
        if txi > l.xi + 2 * l.px:
            continue
        for tyo in yo_c:
            tyi = (tyo - 1) * l.sy + l.ky
            if tyi > l.yi + 2 * l.py:
                continue
            for tci in ci_c:
                for tco in co_c:
                    t = Tile4D(txi, tyi, tci, tco)
                    if tile_spm_bytes(l, t) <= spm_limit:
                        yield t
                        n += 1
                        if n >= max_candidates:
                            return


def optimize_tile(
    l: ConvLayerSpec,
    simulate,               # callable(layer, tile) -> TilePerf
    spm_limit: int,
    objective: str = "time+energy",
    time_slack: float = 0.03,
) -> tuple[Tile4D, TilePerf]:
    """Paper §IV-A/§VI: pick the optimal tile under the scratchpad constraint.

    The paper optimizes "based on performance, energy efficiency, available
    SPM size, and required DRAM bandwidth" — a two-stage objective: find the
    minimum modeled time, then among tiles within ``time_slack`` of it pick
    the one with least DRAM traffic (DRAM dominates cube energy, §VI-B).
    ``simulate`` is the machine model (``core.smc.SMCModel.simulate_layer``
    or a TPU analogue).
    """
    evaluated: list[tuple[Tile4D, TilePerf]] = []
    for t in tile_candidates(l, spm_limit):
        perf = simulate(l, t)
        if perf is not None:
            evaluated.append((t, perf))
    if not evaluated:
        raise ValueError(
            f"no feasible tile for layer {l.name} under SPM limit {spm_limit}"
        )
    if objective == "traffic":
        return min(evaluated, key=lambda tp: tp[1].dram_read_bytes)
    t_best = min(tp[1].total_cycles for tp in evaluated)
    if objective == "time":
        return min(evaluated, key=lambda tp: tp[1].total_cycles)
    near = [tp for tp in evaluated if tp[1].total_cycles <= t_best * (1 + time_slack)]
    return min(near, key=lambda tp: tp[1].dram_read_bytes)


def oi_for_tiles(l: ConvLayerSpec, t: Tile4D) -> float:
    """Operational intensity (FLOPs per DRAM byte) of a tiled layer —
    §II-A footnote 1.  Read traffic: every input tile is fetched once per
    T_Co block; coefficients once per (input,output) tile pair; outputs
    written once (partial sums stay in SPM — §IV-A 'partial computations')."""
    n_ci = math.ceil(l.ci / t.tci)
    n_co = math.ceil(l.co / t.tco)
    n_xy = math.ceil(l.xo / t.txo(l)) * math.ceil(l.yo / t.tyo(l))
    read_in = n_xy * n_co * n_ci * (t.txi * t.tyi * t.tci) * 4
    read_coef = n_xy * n_co * n_ci * (l.kx * l.ky * t.tci * t.tco) * 4
    write_out = l.out_bytes
    return l.flops / max(read_in + read_coef + write_out, 1)
