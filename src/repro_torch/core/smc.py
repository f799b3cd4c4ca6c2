"""Smart-Memory-Cube machine model + epoch simulator (paper §III/§VI): the
port of ``repro/core/smc.py``.

Reimplements the paper's "epoch-based in-house simulator": a cycle-approximate
model of one SMC (NeuroCluster on the HMC logic die) executing a 4D-tiled
ConvNet layer-by-layer, plus the power model used for the GFLOPS/W claims and
the multi-SMC network estimate (§VI-C).

Calibration targets (asserted loosely in tests/benchmarks):
  * >90 % of the roofline at optimal tiles (Fig 8)
  * ~240 GFLOPS average across the ConvNet zoo (Fig 9a)
  * 22.5 GFLOPS/W cube-level, ~117 GFLOPS/W NeuroCluster-level (§VI-B)
  * 955 GFLOPS @ 42.8 W for the 4-SMC network → 4.8× Tesla K40 (§VI-C)

Plain Python with the JAX package's numbers and arithmetic, kept as the
port's own copy.  One addition: ``SMCModel`` remembers each layer's optimal
tile by the layer's shape (every field but its name), since the search is a
pure function of it and the zoo's ResNets repeat a few dozen shapes over
hundreds of layers.  ``make_cube_mesh`` and ``cube_rules`` (a JAX device
mesh of cubes and its sharding rules) are not ported: they come with the
port's routing and cube processes.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Sequence
from dataclasses import dataclass

from .tiling import ConvLayerSpec, Tile4D, TilePerf, optimize_tile, tile_spm_bytes

# ---------------------------------------------------------------------------
# Machine description (Figure 1b baseline parameters)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SMCConfig:
    n_clusters: int = 16
    n_pe_per_cluster: int = 4
    n_nst_per_cluster: int = 8
    spm_bytes: int = 128 * 1024          # per cluster, 32 banks, WLI
    spm_banks: int = 32
    clock_hz: float = 1.0e9
    # NST: 1 FP MAC/cycle = 2 FLOPs/cycle
    flops_per_nst_cycle: float = 2.0
    # DRAM (vault aggregate seen by NeuroCluster through 3 AXI ports)
    dram_read_bw: float = 96.0e9          # 3 AXI ports (peak; avg usage ~32, §VI-A)
    dram_peak_bw: float = 96.0e9          # 3 AXI ports burst
    # overheads (cycles)
    nst_cmd_issue_cycles: float = 2.0     # per-stream issue (FIFO-hidden, Fig 5b)
    nst_stream_setup_cycles: float = 10.0  # AGU/HWL reconfig once per stream
    dma_setup_cycles: float = 120.0       # per bulk transfer
    layer_sync_cycles: float = 2000.0     # cluster barrier per layer
    # SPM bank-conflict efficiency by banking factor (Fig 7, BF = banks/ports)
    # with BF=2 (32 banks / 16 NST ports) the paper reports >93 % efficiency.
    bank_eff: float = 0.93

    @property
    def n_nst(self) -> int:
        return self.n_clusters * self.n_nst_per_cluster

    @property
    def peak_flops(self) -> float:
        return self.n_nst * self.flops_per_nst_cycle * self.clock_hz  # 256 GF


@dataclass(frozen=True)
class SMCPower:
    """§VI-B power model (28nm FDSOI synthesis results)."""

    neurocluster_w: float = 2.2          # busy NeuroCluster
    dram_w_per_gbs: float = 0.15         # DRAM dynamic power per GB/s read
    dram_static_w: float = 2.3           # refresh + standby of 4 dies
    serial_link_w: float = 2.5           # per active link (4 links = 10 W)
    smc_ctrl_w: float = 0.8
    # host-side alternative (§VI-B): same accelerator behind the links
    host_side_extra_w: float = 10.2
    # Tesla K40 reference (§VI-C)
    k40_gflops: float = 1092.0
    k40_power_w: float = 235.0

    def cube_power(self, read_bw_gbs: float, links_active: int = 0) -> float:
        return (
            self.neurocluster_w
            + self.dram_static_w
            + self.dram_w_per_gbs * read_bw_gbs
            + self.smc_ctrl_w
            + self.serial_link_w * links_active
        )


# ---------------------------------------------------------------------------
# Per-layer epoch simulation
# ---------------------------------------------------------------------------


@dataclass
class LayerReport:
    layer: ConvLayerSpec
    tile: Tile4D
    perf: TilePerf
    time_s: float
    gflops: float
    breakdown: dict[str, float]    # fractions: compute/dma/init/sync/conflict


class SMCModel:
    """Cycle-approximate model of one SMC running tiled ConvNet layers."""

    def __init__(self, cfg: SMCConfig | None = None, power: SMCPower | None = None):
        self.cfg = cfg or SMCConfig()
        self.power = power or SMCPower()
        self._tiles: dict[ConvLayerSpec, tuple[Tile4D, TilePerf]] = {}

    # -- core model ---------------------------------------------------------

    def simulate_layer(self, l: ConvLayerSpec, t: Tile4D) -> TilePerf | None:
        cfg = self.cfg
        if tile_spm_bytes(l, t) > cfg.spm_bytes:
            return None
        txo, tyo = t.txo(l), t.tyo(l)
        n_xy = math.ceil(l.xo / txo) * math.ceil(l.yo / tyo)
        n_co = math.ceil(l.co / t.tco)
        n_ci = math.ceil(l.ci / t.tci) if l.kind != "pool" else 1
        n_out_tiles = n_xy * n_co

        # --- compute cycles for ONE output tile (one cluster) --------------
        # Each STREAM_MAC computes one output element: K_y*K_x*T_Ci MACs.
        stream_len = l.kx * l.ky * (t.tci if l.kind != "pool" else 1)
        streams_per_tile = txo * tyo * t.tco
        # NSTs work in parallel within a cluster; PEs keep their FIFOs full.
        issue = cfg.nst_cmd_issue_cycles
        per_stream = stream_len / cfg.bank_eff + issue
        compute_tile = n_ci * (
            streams_per_tile * per_stream / cfg.n_nst_per_cluster
            + cfg.nst_stream_setup_cycles
        )

        # --- DMA cycles for ONE output tile ---------------------------------
        in_bytes = n_ci * (t.txi * t.tyi * t.tci) * 4
        coef_bytes = n_ci * (l.kx * l.ky * t.tci * t.tco) * 4 if l.kind != "pool" else 0
        out_bytes = txo * tyo * t.tco * 4
        # per-cluster share of the DRAM read bandwidth
        bw_per_cluster = cfg.dram_read_bw / cfg.n_clusters
        bytes_per_cycle = bw_per_cluster / cfg.clock_hz
        dma_tile = (in_bytes + coef_bytes) / bytes_per_cycle + cfg.dma_setup_cycles * (
            n_ci + 1
        )
        # writes use small DMAs for zig-zag reorganization (§IV-A) but are off
        # the critical path (<4 % of read bw) — modeled as overlapped.

        # --- layer total: ping-pong overlap (max), tiles round-robin over
        #     clusters, one barrier at the layer end ------------------------
        rounds = math.ceil(n_out_tiles / cfg.n_clusters)
        tile_cycles = max(compute_tile, dma_tile)
        total = rounds * tile_cycles + cfg.layer_sync_cycles

        reads = n_out_tiles * (in_bytes + coef_bytes)
        writes = n_out_tiles * out_bytes
        oi = l.flops / max(reads + writes, 1)
        return TilePerf(
            tile=t,
            n_tiles=n_out_tiles,
            macs=l.macs,
            dram_read_bytes=reads,
            dram_write_bytes=writes,
            compute_cycles=rounds * compute_tile,
            dma_cycles=rounds * dma_tile,
            total_cycles=total,
            oi=oi,
            spm_bytes=tile_spm_bytes(l, t),
        )

    # -- network-level ------------------------------------------------------

    def optimize_layer(self, l: ConvLayerSpec) -> tuple[Tile4D, TilePerf]:
        shape = dataclasses.replace(l, name="")
        if shape not in self._tiles:
            self._tiles[shape] = optimize_tile(l, self.simulate_layer, self.cfg.spm_bytes)
        return self._tiles[shape]

    def run_convnet(self, layers: Sequence[ConvLayerSpec]) -> list[LayerReport]:
        reports = []
        for l in layers:
            tile, perf = self.optimize_layer(l)
            time_s = perf.total_cycles / self.cfg.clock_hz
            gflops = l.flops / time_s / 1e9
            comp = perf.compute_cycles
            dma = perf.dma_cycles
            stall = (dma - comp) / perf.total_cycles if dma > comp else 0.0
            init = (
                self.cfg.nst_cmd_issue_cycles
                * perf.n_tiles
                * perf.tile.txo(l) * perf.tile.tyo(l) * perf.tile.tco
                / self.cfg.n_nst_per_cluster
                / self.cfg.n_clusters
            ) / perf.total_cycles
            reports.append(
                LayerReport(
                    layer=l,
                    tile=tile,
                    perf=perf,
                    time_s=time_s,
                    gflops=gflops,
                    breakdown={
                        "dma_stall": max(0.0, stall),
                        "nst_init": min(1.0, init),
                        "sync": self.cfg.layer_sync_cycles / perf.total_cycles,
                        "spm_conflict": 1.0 - self.cfg.bank_eff,
                    },
                )
            )
        return reports

    def convnet_summary(self, layers: Sequence[ConvLayerSpec]) -> dict:
        reps = self.run_convnet(layers)
        time_s = sum(r.time_s for r in reps)
        flops = sum(r.layer.flops for r in reps)
        reads = sum(r.perf.dram_read_bytes for r in reps)
        writes = sum(r.perf.dram_write_bytes for r in reps)
        gflops = flops / time_s / 1e9
        read_bw_gbs = reads / time_s / 1e9
        cube_w = self.power.cube_power(read_bw_gbs)
        return {
            "time_s": time_s,
            "gflops": gflops,
            "fps": 1.0 / time_s,
            "dram_read_gb": reads / 1e9,
            "dram_write_gb": writes / 1e9,
            "avg_read_bw_gbs": read_bw_gbs,
            "write_read_ratio": writes / max(reads, 1),
            "oi": flops / max(reads + writes, 1),
            "cube_power_w": cube_w,
            "gflops_per_w_cube": gflops / cube_w,
            "gflops_per_w_cluster": gflops / self.power.neurocluster_w,
            "roofline_fraction": gflops / (self.roofline_gflops(flops / max(reads + writes, 1))),
            "reports": reps,
        }

    def roofline_gflops(self, oi: float) -> float:
        """min(peak compute, OI × DRAM bandwidth) in GFLOPS (§VI-A Fig 8)."""
        peak = self.cfg.peak_flops * self.cfg.bank_eff / 1e9
        return min(peak, oi * self.cfg.dram_read_bw / 1e9)


# ---------------------------------------------------------------------------
# Multi-SMC network (§VI-C)
# ---------------------------------------------------------------------------


@dataclass
class SMCNetworkReport:
    n_cubes: int
    gflops: float
    power_w: float
    gflops_per_w: float
    speedup_vs_k40_eff: float


# The mesh axis that carries cube-parallel (SMC-network) traffic.  It is the
# same axis the production mesh calls "pod": each slot along it ≙ one SMC
# working on independent inputs with coefficients replicated per cube, so the
# LM stack's logical→mesh rule table ("batch" → (pod, data)) routes batch
# parallelism over cubes with no special-casing.
CUBE_AXIS = "pod"


def simulate_smc_network(
    model: SMCModel,
    layers: Sequence[ConvLayerSpec],
    n_cubes: int = 4,
    image_mb_per_s: float = 10.0,
) -> SMCNetworkReport:
    """Each cube runs one image independently (coefficients preloaded); the
    host keeps Link0 active, other links duty-cycle for ~10 MB/s image input."""
    summary = model.convnet_summary(layers)
    gflops = summary["gflops"] * n_cubes
    # per-cube power with links off + host link share + duty-cycled transfers
    link_duty = image_mb_per_s / (16.0 * 1024)  # of a 16 GB/s link
    per_cube = model.power.cube_power(
        summary["avg_read_bw_gbs"], links_active=link_duty
    )
    host_link = model.power.serial_link_w  # Link0 always on
    power = per_cube * n_cubes + host_link
    eff = gflops / power
    k40_eff = model.power.k40_gflops / model.power.k40_power_w
    return SMCNetworkReport(
        n_cubes=n_cubes,
        gflops=gflops,
        power_w=power,
        gflops_per_w=eff,
        speedup_vs_k40_eff=eff / k40_eff,
    )
