"""Inception-v3 for FID and frame-level IS — the counterpart of
`dvdgan_tpu/eval/inception.py`.

Published FID embeds frames with Inception-v3's 2048-d pool feature. The
units carry the reference's names (torchvision's module names), so weights
in the reference's npz layout (`name/w` HWIO kernels, `name/bn/*` moments;
`tools/convert_inception_weights.py` writes them) load by name
(`load_npz`).

Inference only: conv + BatchNorm with stored moments (eps 1e-3) + ReLU per
unit; the stem's VALID convs and pools, then blocks A–E, each the
concatenation of its branches in the reference's order. Input (B, H, W, 3)
in [−1, 1], resized to 299² (the published preprocessing) unless
resize=None (the VALID stem needs at least 75²). Features "pool" (2048-d
global mean) or "logits" (1000-d).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from dvdgan_tpu_torch.eval import layers

NUM_CLASSES = 1000
FEATURE_DIMS = {"pool": 2048, "logits": NUM_CLASSES}

# stem: (name, kernel (kh,kw), stride, padding, cin, cout) or a pool marker
_STEM = (
    ("Conv2d_1a_3x3", (3, 3), 2, "VALID", 3, 32),
    ("Conv2d_2a_3x3", (3, 3), 1, "VALID", 32, 32),
    ("Conv2d_2b_3x3", (3, 3), 1, "SAME", 32, 64),
    ("maxpool1",),
    ("Conv2d_3b_1x1", (1, 1), 1, "VALID", 64, 80),
    ("Conv2d_4a_3x3", (3, 3), 1, "VALID", 80, 192),
    ("maxpool2",),
)

# Mixed blocks: (name, kind, cin, extra)
#   A: extra = pool_features; out = 224 + pf
#   B: out = cin + 480
#   C: extra = c7; out = 768
#   D: out = cin + 512
#   E: out = 2048
_MIXED = (
    ("Mixed_5b", "A", 192, 32),
    ("Mixed_5c", "A", 256, 64),
    ("Mixed_5d", "A", 288, 64),
    ("Mixed_6a", "B", 288, None),
    ("Mixed_6b", "C", 768, 128),
    ("Mixed_6c", "C", 768, 160),
    ("Mixed_6d", "C", 768, 160),
    ("Mixed_6e", "C", 768, 192),
    ("Mixed_7a", "D", 768, None),
    ("Mixed_7b", "E", 1280, None),
    ("Mixed_7c", "E", 2048, None),
)


def _branches(kind: str, cin: int, extra) -> list:
    """The branch convs of a block: (name, kernel, stride, padding, cin,
    cout)."""
    if kind == "A":
        return [
            ("branch1x1", (1, 1), 1, "SAME", cin, 64),
            ("branch5x5_1", (1, 1), 1, "SAME", cin, 48),
            ("branch5x5_2", (5, 5), 1, "SAME", 48, 64),
            ("branch3x3dbl_1", (1, 1), 1, "SAME", cin, 64),
            ("branch3x3dbl_2", (3, 3), 1, "SAME", 64, 96),
            ("branch3x3dbl_3", (3, 3), 1, "SAME", 96, 96),
            ("branch_pool", (1, 1), 1, "SAME", cin, extra),
        ]
    if kind == "B":
        return [
            ("branch3x3", (3, 3), 2, "VALID", cin, 384),
            ("branch3x3dbl_1", (1, 1), 1, "SAME", cin, 64),
            ("branch3x3dbl_2", (3, 3), 1, "SAME", 64, 96),
            ("branch3x3dbl_3", (3, 3), 2, "VALID", 96, 96),
        ]
    if kind == "C":
        c7 = extra
        return [
            ("branch1x1", (1, 1), 1, "SAME", cin, 192),
            ("branch7x7_1", (1, 1), 1, "SAME", cin, c7),
            ("branch7x7_2", (1, 7), 1, "SAME", c7, c7),
            ("branch7x7_3", (7, 1), 1, "SAME", c7, 192),
            ("branch7x7dbl_1", (1, 1), 1, "SAME", cin, c7),
            ("branch7x7dbl_2", (7, 1), 1, "SAME", c7, c7),
            ("branch7x7dbl_3", (1, 7), 1, "SAME", c7, c7),
            ("branch7x7dbl_4", (7, 1), 1, "SAME", c7, c7),
            ("branch7x7dbl_5", (1, 7), 1, "SAME", c7, 192),
            ("branch_pool", (1, 1), 1, "SAME", cin, 192),
        ]
    if kind == "D":
        return [
            ("branch3x3_1", (1, 1), 1, "SAME", cin, 192),
            ("branch3x3_2", (3, 3), 2, "VALID", 192, 320),
            ("branch7x7x3_1", (1, 1), 1, "SAME", cin, 192),
            ("branch7x7x3_2", (1, 7), 1, "SAME", 192, 192),
            ("branch7x7x3_3", (7, 1), 1, "SAME", 192, 192),
            ("branch7x7x3_4", (3, 3), 2, "VALID", 192, 192),
        ]
    return [                                          # E
        ("branch1x1", (1, 1), 1, "SAME", cin, 320),
        ("branch3x3_1", (1, 1), 1, "SAME", cin, 384),
        ("branch3x3_2a", (1, 3), 1, "SAME", 384, 384),
        ("branch3x3_2b", (3, 1), 1, "SAME", 384, 384),
        ("branch3x3dbl_1", (1, 1), 1, "SAME", cin, 448),
        ("branch3x3dbl_2", (3, 3), 1, "SAME", 448, 384),
        ("branch3x3dbl_3a", (1, 3), 1, "SAME", 384, 384),
        ("branch3x3dbl_3b", (3, 1), 1, "SAME", 384, 384),
        ("branch_pool", (1, 1), 1, "SAME", cin, 192),
    ]


def param_shapes() -> dict:
    """{flat_key: shape} in the reference's npz layout."""
    out = {}

    def unit(prefix, k, cin, cout):
        out[f"{prefix}/w"] = (*k, cin, cout)
        for s in ("scale", "offset", "mean", "var"):
            out[f"{prefix}/bn/{s}"] = (cout,)

    for spec in _STEM:
        if len(spec) > 1:
            name, k, _, _, cin, cout = spec
            unit(name, k, cin, cout)
    for name, kind, cin, extra in _MIXED:
        for bname, k, _, _, bcin, bcout in _branches(kind, cin, extra):
            unit(f"{name}/{bname}", k, bcin, bcout)
    out["fc/w"] = (2048, NUM_CLASSES)
    out["fc/b"] = (NUM_CLASSES,)
    return out


def n_params() -> int:
    return int(sum(np.prod(s) for s in param_shapes().values()))


def init(gen: torch.Generator) -> dict[str, torch.Tensor]:
    """Random params: He-normal kernels from `gen`, BN at identity (not
    the reference's `jax.random` init; never published-comparable)."""
    return layers.to_port(layers.he_init(gen, param_shapes()))


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """The reference's npz layout, validated against the topology, in the
    port's layout."""
    loaded = layers.read_npz(path)
    layers.check_topology(loaded, param_shapes(), "Inception-v3")
    return layers.to_port(loaded)


# ------------------------------------------------------------------ apply ----

def _max_pool3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def _avg_pool3_s1_same(x: torch.Tensor) -> torch.Tensor:
    """A zero-padded 3×3 window sum over 9 (count_include_pad)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _mixed(params: dict, name: str, kind: str, cin: int, extra,
           x: torch.Tensor) -> torch.Tensor:
    spec = {b[0]: b for b in _branches(kind, cin, extra)}

    def b(branch, inp):
        _, _, stride, padding, _, _ = spec[branch]
        return layers.conv_bn_relu(params, f"{name}/{branch}", inp, stride,
                                   padding)

    def chain(inp, *branches):
        for br in branches:
            inp = b(br, inp)
        return inp

    if kind == "A":
        parts = [b("branch1x1", x),
                 chain(x, "branch5x5_1", "branch5x5_2"),
                 chain(x, "branch3x3dbl_1", "branch3x3dbl_2",
                       "branch3x3dbl_3"),
                 b("branch_pool", _avg_pool3_s1_same(x))]
    elif kind == "B":
        parts = [b("branch3x3", x),
                 chain(x, "branch3x3dbl_1", "branch3x3dbl_2",
                       "branch3x3dbl_3"),
                 _max_pool3_s2(x)]
    elif kind == "C":
        parts = [b("branch1x1", x),
                 chain(x, "branch7x7_1", "branch7x7_2", "branch7x7_3"),
                 chain(x, "branch7x7dbl_1", "branch7x7dbl_2",
                       "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5"),
                 b("branch_pool", _avg_pool3_s1_same(x))]
    elif kind == "D":
        parts = [chain(x, "branch3x3_1", "branch3x3_2"),
                 chain(x, "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
                       "branch7x7x3_4"),
                 _max_pool3_s2(x)]
    else:                                             # E
        h = b("branch3x3_1", x)
        hd = chain(x, "branch3x3dbl_1", "branch3x3dbl_2")
        parts = [b("branch1x1", x),
                 b("branch3x3_2a", h), b("branch3x3_2b", h),
                 b("branch3x3dbl_3a", hd), b("branch3x3dbl_3b", hd),
                 b("branch_pool", _avg_pool3_s1_same(x))]
    return torch.cat(parts, dim=1)


def apply(params: dict, images: torch.Tensor, feature: str = "pool",
          resize: Optional[int] = 299) -> torch.Tensor:
    """(B, H, W, 3) in [−1, 1] -> (B, D) f32 on the params' device;
    feature "pool" (2048-d, the FID embedding) or "logits" (1000-d)."""
    x = images.to(params["fc/b"].device, torch.float32)
    x = x.permute(0, 3, 1, 2)                          # (B, 3, H, W)
    if resize is not None:
        x = layers.resize_bilinear(x, resize)
    x = x.contiguous()
    for spec in _STEM:
        if len(spec) == 1:
            x = _max_pool3_s2(x)
        else:
            name, _, stride, padding, _, _ = spec
            x = layers.conv_bn_relu(params, name, x, stride, padding)
    for name, kind, cin, extra in _MIXED:
        x = _mixed(params, name, kind, cin, extra, x)
    x = x.mean(dim=(2, 3))                             # (B, 2048)
    if feature == "pool":
        return x
    return x @ params["fc/w"] + params["fc/b"]
