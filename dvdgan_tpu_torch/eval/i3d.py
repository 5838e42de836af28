"""I3D (inflated Inception-v1 3-D) for FVD — the counterpart of
`dvdgan_tpu/eval/i3d.py`.

Published FVD (Unterthiner et al. 2018) embeds clips with I3D (Carreira &
Zisserman 2017) pretrained on Kinetics-400 and takes the 400 logits as the
feature. `TOPOLOGY` names every unit as the reference does, so weights
carried in the reference's npz layout (`name/w` DHWIO kernels, `name/bn/*`
moments; `tools/convert_i3d_weights.py` writes them from a PyTorch
checkpoint) load by name (`load_npz`) and give the reference's features.

Inference only: conv + BatchNorm with stored moments (eps 1e-3) + ReLU per
unit, convs and max pools padded by XLA's SAME rule (`layers.conv`,
`layers.max_pool_same`: `Conv3d_1a_7x7` at stride 2 on 224 pads 2 before and
3 after). Input (B, T, H, W, 3) in [−1, 1], frames resized to 224² (the
published preprocessing) unless resize=None; features "logits" (400-d) or
"avgpool" (the 1024-d global mean of Mixed_5c).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dvdgan_tpu_torch.eval import layers

NUM_CLASSES = 400      # Kinetics-400 logits
FEATURE_DIMS = {"logits": NUM_CLASSES, "avgpool": 1024}

# Inception branch widths per Mixed block: (b0, b1a, b1b, b2a, b2b, b3b);
# b1a/b2a are 1×1 reductions, b1b/b2b 3×3×3, b3b the 1×1 after the 3×3×3
# max pool. Out channels = b0 + b1b + b2b + b3b.
_MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),     # in 192 -> 256
    "Mixed_3c": (128, 128, 192, 32, 96, 64),   # in 256 -> 480
    "Mixed_4b": (192, 96, 208, 16, 48, 64),    # in 480 -> 512
    "Mixed_4c": (160, 112, 224, 24, 64, 64),   # in 512 -> 512
    "Mixed_4d": (128, 128, 256, 24, 64, 64),   # in 512 -> 512
    "Mixed_4e": (112, 144, 288, 32, 64, 64),   # in 512 -> 528
    "Mixed_4f": (256, 160, 320, 32, 128, 128), # in 528 -> 832
    "Mixed_5b": (256, 160, 320, 32, 128, 128), # in 832 -> 832
    "Mixed_5c": (384, 192, 384, 48, 128, 128), # in 832 -> 1024
}

# The graph in execution order: (name, kind, spec)
#   conv: (kernel (kT,kH,kW), stride (sT,sH,sW), cin, cout)
#   pool: (window, stride) — max pool, SAME padding
#   mixed: cin
TOPOLOGY = (
    ("Conv3d_1a_7x7", "conv", ((7, 7, 7), (2, 2, 2), 3, 64)),
    ("MaxPool3d_2a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
    ("Conv3d_2b_1x1", "conv", ((1, 1, 1), (1, 1, 1), 64, 64)),
    ("Conv3d_2c_3x3", "conv", ((3, 3, 3), (1, 1, 1), 64, 192)),
    ("MaxPool3d_3a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
    ("Mixed_3b", "mixed", 192),
    ("Mixed_3c", "mixed", 256),
    ("MaxPool3d_4a_3x3", "pool", ((3, 3, 3), (2, 2, 2))),
    ("Mixed_4b", "mixed", 480),
    ("Mixed_4c", "mixed", 512),
    ("Mixed_4d", "mixed", 512),
    ("Mixed_4e", "mixed", 512),
    ("Mixed_4f", "mixed", 528),
    ("MaxPool3d_5a_2x2", "pool", ((2, 2, 2), (2, 2, 2))),
    ("Mixed_5b", "mixed", 832),
    ("Mixed_5c", "mixed", 832),
)


def mixed_out_channels(name: str) -> int:
    b0, _, b1b, _, b2b, b3b = _MIXED[name]
    return b0 + b1b + b2b + b3b


def unit_shapes(name: str, kind: str, spec) -> dict:
    """{flat_key: shape} (the reference's layout) of one topology entry."""
    out = {}

    def unit(prefix, k, cin, cout):
        out[f"{prefix}/w"] = (*k, cin, cout)
        for s in ("scale", "offset", "mean", "var"):
            out[f"{prefix}/bn/{s}"] = (cout,)

    if kind == "conv":
        k, _, cin, cout = spec
        unit(name, k, cin, cout)
    elif kind == "mixed":
        cin = spec
        b0, b1a, b1b, b2a, b2b, b3b = _MIXED[name]
        unit(f"{name}/b0", (1, 1, 1), cin, b0)
        unit(f"{name}/b1a", (1, 1, 1), cin, b1a)
        unit(f"{name}/b1b", (3, 3, 3), b1a, b1b)
        unit(f"{name}/b2a", (1, 1, 1), cin, b2a)
        unit(f"{name}/b2b", (3, 3, 3), b2a, b2b)
        unit(f"{name}/b3b", (1, 1, 1), cin, b3b)
    return out


def param_shapes() -> dict:
    """Every parameter tensor in the reference's npz layout:
    {flat_key: shape}."""
    shapes = {}
    for name, kind, spec in TOPOLOGY:
        shapes.update(unit_shapes(name, kind, spec))
    shapes["logits/w"] = (1, 1, 1, 1024, NUM_CLASSES)
    shapes["logits/b"] = (NUM_CLASSES,)
    return shapes


def n_params() -> int:
    return int(sum(np.prod(s) for s in param_shapes().values()))


def from_reference(flat: dict) -> dict[str, torch.Tensor]:
    """Reference-layout arrays -> the port's params (CPU, f32); the
    1×1×1 logits kernel becomes its (1024, 400) matrix."""
    flat = dict(flat)
    flat["logits/w"] = np.asarray(flat["logits/w"]).reshape(1024,
                                                            NUM_CLASSES)
    return layers.to_port(flat)


def init(gen: torch.Generator) -> dict[str, torch.Tensor]:
    """Random params: He-normal kernels drawn from `gen`, BN at identity.
    Not the reference's `jax.random` init: self-consistent trends only,
    never published-comparable, and only weights carried in an npz give
    the reference's features."""
    return from_reference(layers.he_init(gen, param_shapes()))


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """The reference's npz layout, validated against the topology (every
    tensor present at its shape, no unknown key), in the port's layout."""
    loaded = layers.read_npz(path)
    layers.check_topology(loaded, param_shapes(), "I3D")
    return from_reference(loaded)


# ------------------------------------------------------------------ apply ----

def _mixed(params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    def unit(branch, inp):
        return layers.conv_bn_relu(params, f"{name}/{branch}", inp)

    b0 = unit("b0", x)
    b1 = unit("b1b", unit("b1a", x))
    b2 = unit("b2b", unit("b2a", x))
    b3 = unit("b3b", layers.max_pool_same(x, (3, 3, 3), (1, 1, 1)))
    return torch.cat([b0, b1, b2, b3], dim=1)


def apply(params: dict, video: torch.Tensor, feature: str = "logits",
          resize: Optional[int] = 224) -> torch.Tensor:
    """(B, T, H, W, 3) in [−1, 1] -> (B, D) f32 on the params' device.

    feature: "logits" (the 400 Kinetics logits, the published-FVD
             embedding) or "avgpool" (the 1024-d Mixed_5c global mean).
    resize:  the side each frame is resized to first (`layers.resize_bilinear`;
             224 in published FVD); None runs at the clip's own size."""
    x = video.to(params["logits/b"].device, torch.float32)
    if resize is not None:
        x = layers.resize_frames(x, resize)
    x = x.permute(0, 4, 1, 2, 3).contiguous()          # (B, 3, T, H, W)
    for name, kind, spec in TOPOLOGY:
        if kind == "conv":
            x = layers.conv_bn_relu(params, name, x, spec[1])
        elif kind == "pool":
            x = layers.max_pool_same(x, *spec)
        else:
            x = _mixed(params, name, x)
    if feature == "avgpool":
        return x.mean(dim=(2, 3, 4))
    return logits_head(params, x)


def logits_head(params: dict, x5c: torch.Tensor) -> torch.Tensor:
    """Mixed_5c activations (B, 1024, T', H', W') -> (B, 400) logits.

    The published head (avg pool (2, 7, 7) stride 1 VALID, the 1×1×1
    logits conv, the mean over the T' − 1 windows) is linear, so it is a
    weighted temporal mean of the spatial means: the end frames weigh
    1/(2(T' − 1)), the inner ones 1/(T' − 1). At T' ≤ 2 (16-frame clips)
    that is a plain mean; the 48-frame protocol has T' = 6."""
    x = x5c.mean(dim=(3, 4))                           # (B, 1024, T')
    tl = x.shape[2]
    if tl > 2:
        w_t = torch.full((tl,), 1.0 / (tl - 1), dtype=x.dtype,
                         device=x.device)
        w_t[0] = w_t[-1] = 0.5 / (tl - 1)
        x = torch.einsum("bdt,t->bd", x, w_t)
    else:
        x = x.mean(dim=2)
    return x @ params["logits/w"] + params["logits/b"]
