"""Layer-by-layer execution of the paper's tiled ConvNets (section IV).

``ConvNetExecutor`` runs a ``zoo`` layer list the way the JAX package's
executor (``repro/core/convnet.py``) does: layer by layer, NHWC activations
and HWIO weights throughout, so fc6 flattens its input in (h, w, c) order
as the JAX executor does.  Three implementations:

  * ``impl="kernel"`` (the default; JAX's ``"pallas"``) — conv layers
    through ``kernels.ops.stream_mac_conv`` with the bias and ReLU in its
    epilogue (rounded as JAX's ``conv + b``, then ``relu``, in x's type),
    max-pool layers through
    ``ops.stream_maxpool`` (after -inf padding where the layer pads, which
    gives ``reduce_window``'s padded result), fc layers through
    ``ops.tiled_matmul``.  On CUDA tensors each is a hand-written kernel, on
    CPU tensors its plain PyTorch version.  The kernels have no backward:
    they refuse inputs that require grad.
  * ``impl="tiled"`` — the explicit 4D-tile schedule of section IV-A for
    the conv layers named in ``tiles``: T_Ci-partial accumulation
    (``D += A * K_AD`` for each input-channel tile A), each partial through
    ``ops.stream_mac_conv``.  Every other layer runs as under ``"kernel"``.
  * ``impl="xla"`` — the differentiable form that JAX's training example
    runs (``lax.conv_general_dilated`` and the padded ``reduce_window``):
    ``F.conv2d`` on permuted views of the NHWC activation and the HWIO
    weight (NCHW and OIHW, channels-last in memory; weight axis 0 is the
    H axis, with stride ``sy`` and padding ``py``, as in JAX), the bias
    added after the convolution in x's type, ``F.max_pool2d`` after -inf
    padding, and ``torch.matmul`` for fc layers.  Autograd runs through it
    end to end.  On the card, a float32 convolution takes its weight
    gradient from ``conv2d_exact_wgrad`` (im2col and one cuBLAS product)
    instead of cuDNN, whose Winograd weight gradient leaves ~5e-8 where
    the reference's direct convolution gives exact zeros; bf16 keeps
    cuDNN's, which leaves none.  It is the training path; no path
    switches to it, or away from it, by itself.

Global average pooling, and the bias and ReLU of fc layers and of the
tiled schedule's summed partials, are plain tensor ops, as in JAX.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.kernels import ops

from .tiling import ConvLayerSpec, Tile4D

Params = dict[str, dict[str, torch.Tensor]]
IMPLS = ("kernel", "tiled", "xla")


def init_params(
    layers: Sequence[ConvLayerSpec], generator: torch.Generator, device,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """He-normal weights ``(kx, ky, ci, co)`` and zero biases for every conv
    and fc layer, drawn from ``generator`` (on its own device) in layer
    order.  The numbers differ from ``jax.random``'s; parity tests carry the
    JAX tree across instead (``repro_torch.convert``)."""
    params: Params = {}
    for l in layers:
        if l.kind == "pool":
            continue
        fan_in = l.kx * l.ky * l.ci
        w = torch.randn((l.kx, l.ky, l.ci, l.co), generator=generator,
                        device=generator.device) * math.sqrt(2.0 / fan_in)
        params[l.name] = {"w": w.to(device=device, dtype=dtype),
                          "b": torch.zeros((l.co,), dtype=dtype, device=device)}
    return params


def _conv(x: torch.Tensor, w: torch.Tensor, l: ConvLayerSpec,
          bias: torch.Tensor | None = None, relu: bool = False) -> torch.Tensor:
    return ops.stream_mac_conv(x, w, stride=(l.sy, l.sx), padding=(l.py, l.px),
                               bias=bias, relu=relu)


def _conv_tiled(x: torch.Tensor, w: torch.Tensor, l: ConvLayerSpec,
                tile: Tile4D) -> torch.Tensor:
    """Executable model of the 4D-tile schedule: T_Ci-partial accumulation
    (paper Fig 3d: D += A*K_AD for each input tile A), the partial sums in
    x's type as in JAX."""
    if l.ci % tile.tci or l.ci // tile.tci < 2:
        return _conv(x, w, l)
    xp = F.pad(x, (0, 0, l.px, l.px, l.py, l.py))
    acc = None
    for lo in range(0, l.ci, tile.tci):
        part = ops.stream_mac_conv(xp[..., lo:lo + tile.tci].contiguous(),
                                   w[:, :, lo:lo + tile.tci].contiguous(),
                                   stride=(l.sy, l.sx))
        acc = part if acc is None else acc + part
    return acc


def _pad_inf(x: torch.Tensor, l: ConvLayerSpec) -> torch.Tensor:
    if l.py or l.px:
        x = F.pad(x, (0, 0, l.px, l.px, l.py, l.py), value=float("-inf"))
    return x


def _maxpool(x: torch.Tensor, l: ConvLayerSpec) -> torch.Tensor:
    return ops.stream_maxpool(_pad_inf(x, l), (l.ky, l.kx), (l.sy, l.sx))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _ConvExactWgrad(torch.autograd.Function):
    """``F.conv2d`` of NCHW x and OIHW w whose backward takes the input
    gradient from the convolution backward (cuDNN on the card) and the
    weight gradient as im2col (``F.unfold``) times the output gradient in
    one matrix product over every (image, position) pair: a direct sum, so
    a weight whose every product is 0 gets exactly 0, as in the
    reference's direct convolution."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, go):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, w, go, stride=ctx.stride,
                                            padding=ctx.padding)
        if ctx.needs_input_grad[1]:
            co, k = w.shape[0], w[0].numel()
            cols = F.unfold(x, w.shape[2:], padding=ctx.padding, stride=ctx.stride)
            gw = (go.transpose(0, 1).reshape(co, -1)
                  @ cols.transpose(0, 1).reshape(k, -1).t()).view_as(w)
        return gx, gw, None, None


def conv2d_exact_wgrad(x: torch.Tensor, w: torch.Tensor, stride: tuple[int, int],
                       padding: tuple[int, int]) -> torch.Tensor:
    """``F.conv2d(x, w, stride=stride, padding=padding)`` (NCHW, OIHW) with
    the weight gradient of ``_ConvExactWgrad``."""
    return _ConvExactWgrad.apply(x, w, tuple(stride), tuple(padding))


def _conv_xla(x: torch.Tensor, w: torch.Tensor, l: ConvLayerSpec) -> torch.Tensor:
    """JAX's ``_conv_xla``: NHWC x, HWIO w, strides (sy, sx), padding (py, px)."""
    xn, wn = _nchw(x), w.permute(3, 2, 0, 1)
    stride, padding = (l.sy, l.sx), (l.py, l.px)
    # float32 on the card: cuDNN picks a Winograd weight gradient for small
    # layers in every mode (the small net's conv4 left 575 of 9,216 stray
    # elements), so the weight gradient skips it
    if x.is_cuda and x.dtype == torch.float32:
        return _nhwc(conv2d_exact_wgrad(xn, wn, stride, padding))
    return _nhwc(F.conv2d(xn, wn, stride=stride, padding=padding))


def _maxpool_xla(x: torch.Tensor, l: ConvLayerSpec) -> torch.Tensor:
    """JAX's ``_maxpool``: ``reduce_window`` max over -inf padding."""
    return _nhwc(F.max_pool2d(_nchw(_pad_inf(x, l)), (l.ky, l.kx), (l.sy, l.sx)))


class ConvNetExecutor:
    """Layer-by-layer tiled ConvNet forward/loss (the paper's section IV
    pipeline).  Runs where its parameters and input lie: on the card through
    the hand-written kernels, on the CPU through their plain versions."""

    def __init__(
        self,
        layers: Sequence[ConvLayerSpec],
        impl: str = "kernel",
        tiles: dict[str, Tile4D] | None = None,
    ):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r} (the JAX "
                             "executor's 'pallas' is 'kernel' here)")
        self.layers = list(layers)
        self.impl = impl
        self.tiles = tiles or {}

    def init(self, generator: torch.Generator, device=None,
             dtype: torch.dtype = torch.float32) -> Params:
        """Random weights on the card, or on the CPU when ``device="cpu"``."""
        return init_params(self.layers, generator, resolve(device), dtype)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC input volume in the parameters' dtype; returns (N, classes)."""
        xla = self.impl == "xla"
        for l in self.layers:
            if l.kind == "pool":
                if l.kx >= x.shape[1] and l.sx == 1:   # global avg pool
                    x = x.mean((1, 2), keepdim=True)
                else:
                    x = _maxpool_xla(x, l) if xla else _maxpool(x, l)
                continue
            w, b = params[l.name]["w"], params[l.name]["b"]
            if l.kind == "fc" and x.ndim == 4 and l.kx == x.shape[1]:
                n = x.shape[0]
                matmul = torch.matmul if xla else ops.tiled_matmul
                x = matmul(x.reshape(n, -1), w.reshape(-1, l.co)).reshape(n, 1, 1, l.co)
            elif xla:
                x = _conv_xla(x, w, l)
            elif self.impl == "tiled" and l.name in self.tiles:
                x = _conv_tiled(x, w, l, self.tiles[l.name])   # bias after the partials
            else:
                x = _conv(x, w, l, b, l.act)          # bias and ReLU in the epilogue
                continue
            if xla:       # out of place: autograd would copy a view written in place
                x = torch.relu(x + b) if l.act else x + b
                continue
            x = x.add_(b)                     # x is this layer's own new output
            if l.act:
                x = x.relu_()
        return x.reshape(x.shape[0], -1)

    def loss_fn(self, params: Params, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logits = self.apply(params, x)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(1, labels.long()[:, None]).mean()

    def flops_per_example(self) -> int:
        return sum(l.flops for l in self.layers if l.kind != "pool")


def make_small_convnet(
    num_classes: int = 10, width: int = 16, input_px: int = 32
) -> list[ConvLayerSpec]:
    """A reduced ConvNet of the paper's family for CPU examples and tests."""
    c = width
    return [
        ConvLayerSpec("conv1", input_px, input_px, 3, c, 3, 3, 1, 1, 1, 1),
        ConvLayerSpec("conv2", input_px, input_px, c, c, 3, 3, 1, 1, 1, 1),
        ConvLayerSpec("pool1", input_px, input_px, c, c, 2, 2, 2, 2, 0, 0, "pool", False),
        ConvLayerSpec("conv3", input_px // 2, input_px // 2, c, 2 * c, 3, 3, 1, 1, 1, 1),
        ConvLayerSpec("pool2", input_px // 2, input_px // 2, 2 * c, 2 * c, 2, 2, 2, 2, 0, 0,
                      "pool", False),
        ConvLayerSpec("conv4", input_px // 4, input_px // 4, 2 * c, 2 * c, 3, 3, 1, 1, 1, 1),
        ConvLayerSpec(
            "pool3", input_px // 4, input_px // 4, 2 * c, 2 * c,
            input_px // 4, input_px // 4, 1, 1, 0, 0, "pool", False,
        ),
        ConvLayerSpec("fc", 1, 1, 2 * c, num_classes, 1, 1, 1, 1, 0, 0, "fc", False),
    ]


def narrow_convnet(
    layers: Sequence[ConvLayerSpec], channel_div: int = 16, input_px: int = 32
) -> list[ConvLayerSpec]:
    """A zoo network cut in width for checks: every channel count divided by
    ``channel_div`` (the image's channels and the classes kept) and the
    input shrunk to ``input_px``, every spatial size scaled alike, so the
    first fc layer still covers the whole final feature map.  Depth and the
    layer structure stay.  Needs spatial sizes that scale exactly (the VGG
    family: 224 to 32 divides every size by 7)."""
    first, last = layers[0], layers[-1]
    scale = first.xi // input_px

    def px(v: int) -> int:
        if v % scale:
            raise ValueError(f"spatial size {v} does not scale by 1/{scale}")
        return v // scale

    out = []
    for l in layers:
        ci = l.ci if l is first else l.ci // channel_div
        co = l.co if l is last else l.co // channel_div
        if l.kind == "fc" and l.xi == 1:         # after the flatten: widths only
            out.append(dataclasses.replace(l, ci=ci, co=co))
            continue
        k = dict(kx=px(l.kx), ky=px(l.ky)) if l.kind == "fc" else {}
        out.append(dataclasses.replace(l, xi=px(l.xi), yi=px(l.yi), ci=ci, co=co, **k))
    return out
