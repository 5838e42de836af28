"""C3D for the published UCF-101 video Inception Score — the counterpart of
`dvdgan_tpu/eval/c3d.py`.

The UCF-101 IS protocol (TGAN, Saito et al. 2017; DVD-GAN's UCF-101
table) scores 16-frame clips at 112² with C3D (Tran et al. 2015)
fine-tuned on UCF-101. Eight 3×3×3 SAME convs with bias and ReLU, the
pools of `_POOLS`, fc6, fc7 and the 101-way fc8, named as the reference
names them, so weights in its npz layout (`tools/convert_c3d_weights.py`)
load by name (`load_npz`, which also returns the protocol's input mean
and channel order).

Input (B, 16, H, W, 3) in [−1, 1]: rescaled to [0, 255], flipped to BGR
where the weights ask for it, resized to 112² unless resize=None, the
protocol's mean (a (3,) vector or a (16, 112, 112, 3) cube) subtracted.
The flatten before fc6 is in (T, H, W, C) order, the reference's: the
channels-first activations are permuted to channels-last first, so fc6's
8192 rows are the reference's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from dvdgan_tpu_torch.eval import layers

NUM_CLASSES = 101       # UCF-101 fine-tune (the Sports-1M original has 487)
CLIP_LEN = 16
FC_DIM = 4096
FLAT_DIM = 8192         # 512 ch × 1 × 4 × 4 after pool5 at 16×112×112

# (name, cin, cout) of the conv trunk: 3×3×3, stride 1, SAME
_CONVS = (
    ("conv1", 3, 64),
    ("conv2", 64, 128),
    ("conv3a", 128, 256),
    ("conv3b", 256, 256),
    ("conv4a", 256, 512),
    ("conv4b", 512, 512),
    ("conv5a", 512, 512),
    ("conv5b", 512, 512),
)
# the max pool after the named conv: (window, stride, THW padding)
_POOLS = {
    "conv1": ((1, 2, 2), (1, 2, 2), (0, 0, 0)),
    "conv2": ((2, 2, 2), (2, 2, 2), (0, 0, 0)),
    "conv3b": ((2, 2, 2), (2, 2, 2), (0, 0, 0)),
    "conv4b": ((2, 2, 2), (2, 2, 2), (0, 0, 0)),
    "conv5b": ((2, 2, 2), (2, 2, 2), (0, 1, 1)),
}

FEATURE_DIMS = {"logits": NUM_CLASSES, "fc6": FC_DIM, "fc7": FC_DIM}


def param_shapes(n_classes: int = NUM_CLASSES) -> dict:
    """{flat_key: shape} in the reference's npz layout (conv w DHWIO; fc w
    (in, out))."""
    shapes = {}
    for name, cin, cout in _CONVS:
        shapes[f"{name}/w"] = (3, 3, 3, cin, cout)
        shapes[f"{name}/b"] = (cout,)
    shapes["fc6/w"] = (FLAT_DIM, FC_DIM)
    shapes["fc6/b"] = (FC_DIM,)
    shapes["fc7/w"] = (FC_DIM, FC_DIM)
    shapes["fc7/b"] = (FC_DIM,)
    shapes["fc8/w"] = (FC_DIM, n_classes)
    shapes["fc8/b"] = (n_classes,)
    return shapes


def n_params(n_classes: int = NUM_CLASSES) -> int:
    return int(sum(np.prod(s) for s in param_shapes(n_classes).values()))


def init(gen: torch.Generator, n_classes: int = NUM_CLASSES
         ) -> dict[str, torch.Tensor]:
    """Random He-normal params from `gen` (not the reference's
    `jax.random` init): self-consistent trends only, never
    published-comparable."""
    return layers.to_port(layers.he_init(gen, param_shapes(n_classes)))


def load_npz(path: str
             ) -> tuple[dict[str, torch.Tensor], Optional[np.ndarray], bool]:
    """-> (params, input_mean or None, input_bgr). Validates the topology
    exactly (n_classes from fc8/b); an unknown key is an error."""
    loaded = layers.read_npz(path)
    input_mean = loaded.pop("input_mean", None)
    input_bgr = bool(loaded.pop("input_bgr", False))
    n_classes = (int(loaded["fc8/b"].shape[0]) if "fc8/b" in loaded
                 else NUM_CLASSES)
    layers.check_topology(loaded, param_shapes(n_classes), "C3D")
    return layers.to_port(loaded), input_mean, input_bgr


def apply(params: dict, video: torch.Tensor, feature: str = "logits",
          resize: Optional[int] = 112, input_mean=None,
          input_bgr: bool = False) -> torch.Tensor:
    """(B, 16, H, W, 3) in [−1, 1] -> (B, D) f32 on the params' device.

    feature: "logits" (n_classes; their softmax feeds the UCF-101 IS) or
             "fc6" / "fc7" (4096-d).
    resize:  the side frames are resized to first (112 in the protocol);
             None requires 112² clips.
    input_mean: subtracted after the [0, 255] rescale and the resize, a
             (3,) vector or a (16, 112, 112, 3) cube."""
    device = params["fc8/b"].device
    x = (video.to(device, torch.float32) + 1.0) * 127.5
    if input_bgr:
        x = x.flip(-1)
    if resize is not None:
        x = layers.resize_frames(x, resize)
    if input_mean is not None:
        x = x - torch.as_tensor(np.asarray(input_mean), dtype=torch.float32,
                                device=device)
    x = x.permute(0, 4, 1, 2, 3).contiguous()          # (B, 3, T, H, W)
    for name, _, _ in _CONVS:
        x = F.conv3d(x, params[f"{name}/w"], params[f"{name}/b"],
                     padding=1).relu_()
        if name in _POOLS:
            window, stride, pad = _POOLS[name]
            x = F.max_pool3d(x, window, stride, padding=pad)
    x = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)   # (B, 8192) THWC
    if x.shape[-1] != FLAT_DIM:
        raise ValueError(
            f"flatten gave {x.shape[-1]} features, want {FLAT_DIM} — C3D "
            "requires 16 frames at 112×112 (use resize=112, window T to 16)")
    x = torch.relu(x @ params["fc6/w"] + params["fc6/b"])
    if feature == "fc6":
        return x
    x = torch.relu(x @ params["fc7/w"] + params["fc7/b"])
    if feature == "fc7":
        return x
    return x @ params["fc8/w"] + params["fc8/b"]
