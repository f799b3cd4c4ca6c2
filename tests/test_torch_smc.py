"""The port's SMC machine model and tile optimizer against the JAX package's.

Both are plain Python over the same numbers, so every number must be
equal, not close: ``==`` on floats.  The nets are those of
``tests/test_smc_model.py``: the seven of the zoo and the 250K, 1M and 4M
scaled ResNets.  The paper gates of that file are then asserted on the
port.

The port's ``SMCModel`` remembers each layer's optimal tile by the layer's
shape (every field but the name).  The reference does not, and searching
every layer of the ten nets twice over would take minutes, so the JAX model
here gets the same memo as an instance attribute that calls its own
``optimize_layer`` once per shape.  The search is a pure function of the
shape; ``test_optimize_layer_equals_jax_without_memo`` holds fresh models
of both sides, with no memo on either, equal layer by layer.
"""
import dataclasses

import pytest

from repro.core import smc as jsmc
from repro.core import tiling as jtiling
from repro.core import zoo as jzoo
from repro_torch.core import smc as tsmc
from repro_torch.core import tiling as ttiling
from repro_torch.core import zoo as tzoo

NETS = ["AlexNet", "GoogLeNet", "ResNet50", "ResNet101", "ResNet152", "VGG16", "VGG19"]
SCALED = ["250K", "1M", "4M"]


def _memo(model):
    cache, search = {}, model.optimize_layer

    def optimize_layer(l):
        shape = dataclasses.replace(l, name="")
        if shape not in cache:
            cache[shape] = search(l)
        return cache[shape]

    model.optimize_layer = optimize_layer
    return model


@pytest.fixture(scope="module")
def models():
    return _memo(jsmc.SMCModel()), tsmc.SMCModel()


@pytest.fixture(scope="module")
def summaries(models):
    jm, tm = models
    return {n: (jm.convnet_summary(jzoo.ZOO[n]()), tm.convnet_summary(tzoo.ZOO[n]()))
            for n in NETS + SCALED}


def _d(x):
    return dataclasses.asdict(x)


def _same_reports(jreps, treps):
    assert len(jreps) == len(treps)
    for j, t in zip(jreps, treps):
        assert _d(t.layer) == _d(j.layer)
        assert _d(t.tile) == _d(j.tile)
        assert _d(t.perf) == _d(j.perf)
        assert (t.time_s, t.gflops, t.breakdown) == (j.time_s, j.gflops, j.breakdown)


@pytest.mark.parametrize("net", NETS + SCALED)
def test_convnet_summary_equals_jax(net, summaries):
    want, got = summaries[net]
    assert set(got) == set(want)
    for k in want:
        if k != "reports":
            assert got[k] == want[k], k
    _same_reports(want["reports"], got["reports"])


def test_run_convnet_equals_jax(models, summaries):
    jm, tm = models
    _same_reports(jm.run_convnet(jzoo.alexnet()), tm.run_convnet(tzoo.alexnet()))
    _same_reports(summaries["VGG16"][0]["reports"], tm.run_convnet(tzoo.vgg16()))


@pytest.mark.parametrize("net,idx", [("AlexNet", 0), ("ResNet50", 5), ("VGG16", 7),
                                     ("VGG16", 2), ("GoogLeNet", 20)])
def test_optimize_layer_equals_jax_without_memo(net, idx):
    jl, tl = jzoo.ZOO[net]()[idx], tzoo.ZOO[net]()[idx]
    jt, jp = jsmc.SMCModel().optimize_layer(jl)
    tt, tp = tsmc.SMCModel().optimize_layer(tl)
    assert (_d(tt), _d(tp)) == (_d(jt), _d(jp))
    assert tsmc.SMCModel().simulate_layer(tl, tt) == tp


@pytest.mark.parametrize("n_cubes", [1, 4])
def test_simulate_smc_network_equals_jax(models, n_cubes):
    jm, tm = models
    want = jsmc.simulate_smc_network(jm, jzoo.ZOO["ResNet152"](), n_cubes=n_cubes)
    got = tsmc.simulate_smc_network(tm, tzoo.ZOO["ResNet152"](), n_cubes=n_cubes)
    assert _d(got) == _d(want)
    assert tsmc.CUBE_AXIS == jsmc.CUBE_AXIS
    assert _d(tsmc.SMCConfig()) == _d(jsmc.SMCConfig())
    assert _d(tsmc.SMCPower()) == _d(jsmc.SMCPower())
    assert tsmc.SMCConfig().peak_flops == jsmc.SMCConfig().peak_flops
    assert tm.roofline_gflops(7.5) == jm.roofline_gflops(7.5)


# (net, layer index): a strided 11x11 conv, a 1x1 bottleneck, 3x3 convs of
# VGG16 at two depths, a pool and an fc layer
TILE_LAYERS = [("AlexNet", 0), ("ResNet50", 5), ("VGG16", 2), ("VGG16", 14), ("VGG16", 4),
               ("VGG16", 18)]


@pytest.mark.parametrize("net,idx", TILE_LAYERS)
def test_tile_optimizer_equals_jax(net, idx):
    jl, tl = jzoo.ZOO[net]()[idx], tzoo.ZOO[net]()[idx]
    assert _d(tl) == _d(jl)
    limit = tsmc.SMCConfig().spm_bytes
    for n in (1, 7, 64, 224, 4096):
        assert ttiling._divisor_like(n) == jtiling._divisor_like(n)
    jc = list(jtiling.tile_candidates(jl, limit))
    tc = list(ttiling.tile_candidates(tl, limit))
    assert [_d(t) for t in tc] == [_d(t) for t in jc] and tc
    for jt, tt in list(zip(jc, tc))[:: max(1, len(tc) // 50)]:
        assert ttiling.tile_spm_bytes(tl, tt) == jtiling.tile_spm_bytes(jl, jt)
        assert ttiling.tile_spm_bytes(tl, tt, False) == jtiling.tile_spm_bytes(jl, jt, False)
        assert ttiling.augmented_tile_overhead(tl, tt) == jtiling.augmented_tile_overhead(jl, jt)
        assert ttiling.oi_for_tiles(tl, tt) == jtiling.oi_for_tiles(jl, jt)
    jm, tm = jsmc.SMCModel(), tsmc.SMCModel()
    for objective in ("time+energy", "time", "traffic"):
        jt, jp = jtiling.optimize_tile(jl, jm.simulate_layer, limit, objective)
        tt, tp = ttiling.optimize_tile(tl, tm.simulate_layer, limit, objective)
        assert (_d(tt), _d(tp)) == (_d(jt), _d(jp)), objective
    with pytest.raises(ValueError, match="no feasible tile"):
        ttiling.optimize_tile(tl, tm.simulate_layer, 16)


# ---------------------------------------------------------------------------
# the paper gates of tests/test_smc_model.py, on the port
# ---------------------------------------------------------------------------


def _port(summaries, nets=NETS):
    return {n: summaries[n][1] for n in nets}


def test_port_fps_within_2x_of_paper(summaries):
    for n, s in _port(summaries).items():
        want = tzoo.PAPER_FPS[n]
        assert want / 2 <= s["fps"] <= want * 2, (n, s["fps"], want)


def test_port_average_gflops_roofline_and_writes(summaries):
    s = _port(summaries)
    avg = sum(v["gflops"] for v in s.values()) / len(s)
    assert 190 <= avg <= 280      # paper: 240 average
    fracs = [v["roofline_fraction"] for v in s.values()]
    assert sum(fracs) / len(fracs) >= 0.88 and max(fracs) >= 0.9
    assert all(v["write_read_ratio"] < 0.06 for v in s.values())


def test_port_cube_efficiency_matches_paper(summaries):
    s = _port(summaries)
    cube = sum(v["gflops_per_w_cube"] for v in s.values()) / len(s)
    cl = sum(v["gflops_per_w_cluster"] for v in s.values()) / len(s)
    assert 17 <= cube <= 28 and 88 <= cl <= 146


def test_port_multi_smc_network_vs_k40(models):
    net = tsmc.simulate_smc_network(models[1], tzoo.ZOO["ResNet152"]())
    assert 800 <= net.gflops <= 1050
    assert 38 <= net.power_w <= 50
    assert 3.8 <= net.speedup_vs_k40_eff <= 5.5


def test_port_backward_pass_under_5pct(summaries, models):
    layers = tzoo.ZOO["ResNet152"]()
    gd_time = sum(l.coeff_bytes for l in layers) / models[1].cfg.dram_read_bw
    assert gd_time / summaries["ResNet152"][1]["time_s"] < 0.05


def test_port_image_scaling_constant_per_pixel(summaries):
    tpp = [summaries[n][1]["time_s"] / mp for n, mp in zip(SCALED, (0.25e6, 1e6, 4e6))]
    assert max(tpp) / min(tpp) < 1.8
