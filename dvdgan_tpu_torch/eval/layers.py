"""Building blocks of the port's scoring networks (`i3d`, `inception`,
`c3d`): the bilinear resize, convs and max pools padded by XLA's SAME rule,
BatchNorm with stored moments, He-normal init from a `torch.Generator`, the
npz check against a topology, and the exact-f32 context the extractors run
in.

Inside the networks activations are channels-first, (N, C, H, W) and
(N, C, T, H, W), the layout of PyTorch's convs, and conv kernels are
PyTorch's (O, I, kH, kW) and (O, I, kT, kH, kW). The reference's npz files
hold HWIO / DHWIO kernels under flat `name/w` keys; `to_port` converts them
once, when the weights are loaded or drawn.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from dvdgan_tpu_torch.ops.layers import pad_same

BN_EPS = 1e-3           # the TF I3D / Inception BatchNorm epsilon


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, size, size): the counterpart of
    `jax.image.resize(..., "bilinear")` over the two spatial dims. JAX
    samples at half-pixel centres and, where it shrinks, widens its
    triangle filter by the scale (antialiasing); `F.interpolate` with
    `antialias=True` does both, and where it stretches it is plain
    bilinear, as JAX is."""
    if tuple(x.shape[-2:]) == (size, size):
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


def resize_frames(video: torch.Tensor, size: int) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, size, size, C), each frame resized by
    `resize_bilinear`."""
    b, t, h, w, c = video.shape
    if (h, w) == (size, size):
        return video
    x = video.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    x = resize_bilinear(x, size)
    return x.permute(0, 2, 3, 1).reshape(b, t, size, size, c)


def conv(x: torch.Tensor, w: torch.Tensor, stride=1,
         padding: str = "SAME") -> torch.Tensor:
    """A 2-D or 3-D conv of channels-first x with a PyTorch-layout kernel,
    padded as XLA pads "SAME" (`ops.layers.pad_same`) or not at all
    ("VALID")."""
    nd = w.dim() - 2
    stride = (stride,) * nd if isinstance(stride, int) else tuple(stride)
    pad: int | tuple[int, ...] = 0
    if padding == "SAME":
        x, pad = pad_same(x, w.shape[2:], stride, range(2, x.dim()))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    fn = F.conv3d if nd == 3 else F.conv2d
    return fn(x, w, stride=stride, padding=pad)


def max_pool_same(x: torch.Tensor, window, stride) -> torch.Tensor:
    """3-D max pool of (N, C, T, H, W), padded with −inf by XLA's SAME
    rule (`reduce_window(-inf, max, padding="SAME")`; a SAME total is at
    most window − 1, so symmetric padding is within the pool's own)."""
    x, pad = pad_same(x, window, stride, range(2, x.dim()),
                      value=float("-inf"))
    return F.max_pool3d(x, window, stride, padding=pad)


def bn_relu_(y: torch.Tensor, params: dict, prefix: str) -> torch.Tensor:
    """ReLU((y − mean) · scale · rsqrt(var + eps) + offset) in place, with
    the stored moments of `prefix/bn/*`, in the reference's order."""
    shape = (1, -1) + (1,) * (y.dim() - 2)

    def get(k):
        return params[f"{prefix}/bn/{k}"].view(shape)

    y.sub_(get("mean")).mul_(get("scale"))
    y.mul_(torch.rsqrt(get("var") + BN_EPS)).add_(get("offset"))
    return y.relu_()


def conv_bn_relu(params: dict, prefix: str, x: torch.Tensor, stride=1,
                 padding: str = "SAME") -> torch.Tensor:
    return bn_relu_(conv(x, params[f"{prefix}/w"], stride, padding),
                    params, prefix)


def to_port(flat: dict) -> dict[str, torch.Tensor]:
    """Reference-layout arrays -> f32 CPU tensors in the port's layout: a
    HWIO or DHWIO kernel becomes (O, I, [kT,] kH, kW); every other array
    (BN vectors, biases, (in, out) matrices) keeps its shape."""
    out = {}
    for k, v in flat.items():
        t = torch.as_tensor(np.asarray(v), dtype=torch.float32)
        if k.endswith("/w") and t.dim() in (4, 5):
            t = t.permute(t.dim() - 1, t.dim() - 2, *range(t.dim() - 2))
        out[k] = t.contiguous()
    return out


def he_init(gen: torch.Generator, shapes: dict) -> dict[str, np.ndarray]:
    """Random weights in the reference's layout: He-normal `/w` tensors
    (std sqrt(2 / fan_in), fan_in the product of all but the last dim),
    BN scale and var 1, every other vector 0; drawn in sorted key order
    from `gen`. Not the reference's `jax.random` draws: only weights
    carried in an npz give the reference's features."""
    params = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith("/w"):
            fan_in = int(np.prod(shape[:-1]))
            params[name] = (torch.randn(shape, generator=gen)
                            * np.sqrt(2.0 / fan_in)).numpy()
        elif name.endswith("/bn/scale") or name.endswith("/bn/var"):
            params[name] = np.ones(shape, np.float32)
        else:
            params[name] = np.zeros(shape, np.float32)
    return params


def check_topology(loaded: dict, expected: dict, what: str) -> None:
    """Raises ValueError, with the reference's message, unless `loaded`
    holds exactly the keys of `expected` at their shapes."""
    missing = sorted(set(expected) - set(loaded))
    extra = sorted(set(loaded) - set(expected))
    bad = [f"{k}: got {loaded[k].shape}, want {expected[k]}"
           for k in expected if k in loaded
           and tuple(loaded[k].shape) != tuple(expected[k])]
    if missing or extra or bad:
        raise ValueError(
            f"npz does not match the {what} topology:\n"
            f"  missing ({len(missing)}): {missing[:5]}...\n"
            f"  unknown ({len(extra)}): {extra[:5]}...\n"
            f"  shape mismatches ({len(bad)}): {bad[:5]}")


def read_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """No autograd, and f32 products without TF32 in cuBLAS and cuDNN, on
    deterministic cuDNN algorithms; the flags as they were afterwards.
    Features that are to be compared with published numbers, or with
    the CPU, must not depend on TF32's 10-bit mantissa."""
    cudnn = torch.backends.cudnn
    saved = (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
             cudnn.deterministic, cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = False, True, False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
         cudnn.deterministic, cudnn.benchmark) = saved
