"""The paper's ConvNet zoo (Table I) as layer-spec lists.

AlexNet (ungrouped, Caffe dims), VGG16/19, GoogLeNet v1, ResNet-50/101/152,
and the paper's scaled ResNets accepting 250K/1M/2M/4M-pixel inputs
(ResNet-152 + one extra C5 bottleneck block per 2× pixel step — this matches
Table I's coefficient growth of ~17 MB per step).

Table I accounting (reverse-engineered from the paper's numbers and matched
by ``table1_row``):  FC layers are excluded;  Max{Neurons/Layer} = max over
layers of input+output activation bytes (f32);  Max{Coeffs/Layer} and Total
Coeffs are conv-only;  Max{Storage/Layer} = max(neurons+coeffs) per layer;
Total = total conv coeffs + max neurons.

The port's own copy of ``repro/core/zoo.py``: the same layer lists and
accounting, so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import math
from .tiling import ConvLayerSpec

MB = 1024 * 1024


def _conv(name, xi, ci, co, k, s=1, p=None, yi=None, kind="conv", act=True):
    if p is None:
        p = k // 2 if s == 1 else 0
    return ConvLayerSpec(
        name=name, xi=xi, yi=yi if yi is not None else xi, ci=ci, co=co,
        kx=k, ky=k, sx=s, sy=s, px=p, py=p, kind=kind, act=act,
    )


def _pool(name, xi, c, k=3, s=2, yi=None):
    return ConvLayerSpec(
        name=name, xi=xi, yi=yi if yi is not None else xi, ci=c, co=c,
        kx=k, ky=k, sx=s, sy=s, px=0, py=0, kind="pool", act=False,
    )


# ---------------------------------------------------------------------------


def alexnet() -> list[ConvLayerSpec]:
    L = []
    L.append(_conv("conv1", 227, 3, 96, 11, s=4, p=0))          # -> 55
    L.append(_pool("pool1", 55, 96))                            # -> 27
    L.append(_conv("conv2", 27, 96, 256, 5, p=2))
    L.append(_pool("pool2", 27, 256))                           # -> 13
    L.append(_conv("conv3", 13, 256, 384, 3))
    L.append(_conv("conv4", 13, 384, 384, 3))
    L.append(_conv("conv5", 13, 384, 256, 3))
    L.append(_pool("pool5", 13, 256))                           # -> 6
    L.append(_conv("fc6", 6, 256, 4096, 6, p=0, kind="fc"))
    L.append(_conv("fc7", 1, 4096, 4096, 1, p=0, kind="fc"))
    L.append(_conv("fc8", 1, 4096, 1000, 1, p=0, kind="fc", act=False))
    return L


def _vgg(cfg: list) -> list[ConvLayerSpec]:
    L, x, ci = [], 224, 3
    for i, item in enumerate(cfg):
        if item == "M":
            L.append(_pool(f"pool{i}", x, ci, k=2, s=2))
            x //= 2
        else:
            L.append(_conv(f"conv{i}", x, ci, item, 3))
            ci = item
    L.append(_conv("fc6", 7, 512, 4096, 7, p=0, kind="fc"))
    L.append(_conv("fc7", 1, 4096, 4096, 1, p=0, kind="fc"))
    L.append(_conv("fc8", 1, 4096, 1000, 1, p=0, kind="fc", act=False))
    return L


def vgg16() -> list[ConvLayerSpec]:
    return _vgg([64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                 512, 512, 512, "M", 512, 512, 512, "M"])


def vgg19() -> list[ConvLayerSpec]:
    return _vgg([64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"])


# GoogLeNet v1 inception table: (1x1, 3x3red, 3x3, 5x5red, 5x5, poolproj)
_INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def googlenet() -> list[ConvLayerSpec]:
    L = []
    L.append(_conv("conv1", 224, 3, 64, 7, s=2, p=3))           # -> 112
    L.append(_pool("pool1", 112, 64))                           # -> 56 (ceil 55->56 approx: (112-3)//2+1=55; use p=1)
    L[-1] = ConvLayerSpec("pool1", 112, 112, 64, 64, 3, 3, 2, 2, 1, 1, "pool", False)
    L.append(_conv("conv2r", 56, 64, 64, 1, p=0))
    L.append(_conv("conv2", 56, 64, 192, 3))
    L.append(ConvLayerSpec("pool2", 56, 56, 192, 192, 3, 3, 2, 2, 1, 1, "pool", False))
    x, ci = 28, 192
    for blk, (c1, r3, c3, r5, c5, pp) in _INCEPTION.items():
        L.append(_conv(f"i{blk}_1x1", x, ci, c1, 1, p=0))
        L.append(_conv(f"i{blk}_3x3r", x, ci, r3, 1, p=0))
        L.append(_conv(f"i{blk}_3x3", x, r3, c3, 3))
        L.append(_conv(f"i{blk}_5x5r", x, ci, r5, 1, p=0))
        L.append(_conv(f"i{blk}_5x5", x, r5, c5, 5, p=2))
        L.append(_conv(f"i{blk}_pp", x, ci, pp, 1, p=0))
        ci = c1 + c3 + c5 + pp
        if blk in ("3b", "4e"):
            L.append(ConvLayerSpec(f"pool_{blk}", x, x, ci, ci, 3, 3, 2, 2, 1, 1, "pool", False))
            x //= 2
    L.append(_pool("pool5", 7, 1024, k=7, s=1))
    L.append(_conv("fc", 1, 1024, 1000, 1, p=0, kind="fc", act=False))
    return L


def _bottleneck(L, name, x, ci, mid, s):
    co = mid * 4
    L.append(_conv(f"{name}_a", x, ci, mid, 1, p=0))
    L.append(_conv(f"{name}_b", x, mid, mid, 3, s=s, p=1))
    xo = (x + 2 - 3) // s + 1
    L.append(_conv(f"{name}_c", xo, mid, co, 1, p=0))
    if ci != co or s != 1:
        L.append(_conv(f"{name}_ds", x, ci, co, 1, s=s, p=0, act=False))
    return xo, co


def _resnet(blocks: list[int], input_px: int = 224, extra_c5: int = 0) -> list[ConvLayerSpec]:
    L = []
    L.append(_conv("conv1", input_px, 3, 64, 7, s=2, p=3))
    x = (input_px + 6 - 7) // 2 + 1
    L.append(ConvLayerSpec("pool1", x, x, 64, 64, 3, 3, 2, 2, 1, 1, "pool", False))
    x = (x + 2 - 3) // 2 + 1
    ci = 64
    mids = [64, 128, 256, 512]
    for stage, (n, mid) in enumerate(zip(blocks, mids)):
        if stage == 3:
            n += extra_c5
        for b in range(n):
            s = 2 if (b == 0 and stage > 0) else 1
            x, ci = _bottleneck(L, f"c{stage+2}_{b}", x, ci, mid, s)
    L.append(_pool("avgpool", x, ci, k=x, s=1))
    L.append(_conv("fc", 1, ci, 1000, 1, p=0, kind="fc", act=False))
    return L


def resnet50() -> list[ConvLayerSpec]:
    return _resnet([3, 4, 6, 3])


def resnet101() -> list[ConvLayerSpec]:
    return _resnet([3, 4, 23, 3])


def resnet152() -> list[ConvLayerSpec]:
    return _resnet([3, 8, 36, 3])


def scaled_resnet(megapixels: float) -> list[ConvLayerSpec]:
    """Paper's 250K/1M/2M/4M networks: ResNet-152 on larger inputs with one
    extra C5 block per 2× pixel step beyond 250K (matches Table I coeffs)."""
    px = int(round(math.sqrt(megapixels * 1e6)))
    extra = max(1, int(round(math.log2(max(megapixels / 0.25, 1)))) + 1)
    return _resnet([3, 8, 36, 3], input_px=px, extra_c5=extra)


ZOO = {
    "AlexNet": alexnet,
    "ResNet50": resnet50,
    "ResNet101": resnet101,
    "ResNet152": resnet152,
    "VGG16": vgg16,
    "VGG19": vgg19,
    "GoogLeNet": googlenet,
    "250K": lambda: scaled_resnet(0.25),
    "1M": lambda: scaled_resnet(1.0),
    "2M": lambda: scaled_resnet(2.0),
    "4M": lambda: scaled_resnet(4.0),
}

# Paper Table I reference values (MB) for validation.
PAPER_TABLE1 = {
    #            max_neur max_coef max_store tot_coef total
    "AlexNet":   (2,  5,  6,  14, 16),
    "ResNet50":  (4,  9,  9,  79, 83),
    "ResNet101": (4,  9,  9, 151, 155),
    "ResNet152": (4,  9,  9, 211, 214),
    "VGG16":     (25, 9, 25,  56, 81),
    "VGG19":     (25, 9, 25,  76, 101),
    "GoogLeNet": (4,  4,  4,  19, 23),
    "250K":      (19, 9, 19, 228, 247),
    "1M":        (76, 9, 76, 245, 321),
    "2M":        (150, 9, 150, 262, 411),
    "4M":        (305, 9, 305, 279, 584),
}

# Paper §VI-A frame rates (220x220x3 frames/s) for validation.
PAPER_FPS = {
    "AlexNet": 126, "GoogLeNet": 83, "ResNet50": 34, "ResNet101": 16,
    "ResNet152": 11, "VGG16": 8, "VGG19": 6,
}


def table1_row(layers: list[ConvLayerSpec]) -> dict[str, float]:
    """Compute Table I metrics (MB) with the paper's accounting."""
    convs = [l for l in layers if l.kind == "conv"]
    neur = max(l.in_bytes + l.out_bytes for l in layers if l.kind != "fc")
    coef = max((l.coeff_bytes for l in convs), default=0)
    store = max((l.in_bytes + l.out_bytes + l.coeff_bytes for l in convs), default=0)
    total_coef = sum(l.coeff_bytes for l in convs)
    return {
        "max_neurons_mb": neur / MB,
        "max_coeffs_mb": coef / MB,
        "max_storage_mb": store / MB,
        "total_coeffs_mb": total_coef / MB,
        "total_mb": (total_coef + neur) / MB,
    }


def total_macs(layers: list[ConvLayerSpec]) -> int:
    return sum(l.macs for l in layers if l.kind != "pool")
