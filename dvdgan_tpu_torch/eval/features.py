"""Video feature extractors for FVD / IS / FID — the counterpart of
`dvdgan_tpu/eval/features.py`.

An extractor is a callable (B, T, H, W, 3) in [−1, 1] -> float64 numpy
(B, D); `InceptionFeatures` folds clips to frames, (B·T, D). Each runs on
the `device` it is given (the CLI and the trainer pass the run's device;
none falls back to the CPU), in f32 with TF32 off and deterministic cuDNN
(`layers.exact_f32`), and takes numpy arrays (the real clips) or torch
tensors (EMA-G's clips, which stay on the device).

  * `I3DFeatures`: the I3D topology (`eval.i3d`). With `weights_npz` (the
    reference's npz layout) its logits are the published-FVD embedding;
    without, it runs at a seeded random init and `pretrained` is False:
    callers label such numbers as not published-comparable.
  * `InceptionFeatures`, `C3DFeatures`: the same for Inception-v3 (frame
    FID) and C3D (the UCF-101 IS protocol; clips windowed to 16 frames).
  * `I3DLikeFeatures`: a 4-layer 3-D conv stack, a cheap stand-in for
    tests and in-training trends; its numbers compare only within one
    instance.
  * `ClassifierProbs`, `C3DClassifierProbs`, `I3DClassifierProbs`: softmax
    class probabilities for IS. The last two share their extractor's
    logits (`fx`, `from_features`), so one forward serves FVD and IS.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from dvdgan_tpu_torch.core import init as winit
from dvdgan_tpu_torch.eval import c3d, i3d, inception, layers
from dvdgan_tpu_torch.ops.layers import linear, linear_init

Video = Union[np.ndarray, torch.Tensor]


def _on(params: dict, device) -> dict:
    return {k: v.to(device) for k, v in params.items()}


def _video(video: Video, device: torch.device) -> torch.Tensor:
    """The clip batch as f32 on `device` (a device tensor is cast there,
    not copied through the host)."""
    return torch.as_tensor(video).to(device, torch.float32)


def _host(feats: torch.Tensor) -> np.ndarray:
    return feats.cpu().numpy().astype(np.float64)


class I3DFeatures:
    """I3D extractor: (B, T, H, W, 3)[−1, 1] -> (B, D).

    feature: "logits" (400-d, the published-FVD embedding) or "avgpool"
    (1024-d). `pretrained` is True only when weights were loaded."""

    def __init__(self, weights_npz: Optional[str] = None, seed: int = 0,
                 feature: str = "logits", resize: Optional[int] = 224,
                 device: Union[str, torch.device] = "cuda"):
        if feature not in i3d.FEATURE_DIMS:
            raise ValueError(f"feature must be one of {list(i3d.FEATURE_DIMS)}")
        self.device = torch.device(device)
        self.pretrained = weights_npz is not None
        params = (i3d.load_npz(weights_npz) if weights_npz
                  else i3d.init(torch.Generator().manual_seed(seed)))
        self.params = _on(params, self.device)
        self.feature = feature
        self.resize = resize

    def __call__(self, video: Video) -> np.ndarray:
        with layers.exact_f32():
            return _host(i3d.apply(self.params, _video(video, self.device),
                                   self.feature, self.resize))


class InceptionFeatures:
    """Inception-v3 frame extractor for FID / frame IS: (B, T, H, W, 3)
    [−1, 1] -> (B·T, D) per-frame features (FID pools every frame, the
    published frame-level protocol).

    feature: "pool" (2048-d, the published-FID embedding) or "logits"
    (1000-d). `pretrained` is True only when weights were loaded."""

    def __init__(self, weights_npz: Optional[str] = None, seed: int = 0,
                 feature: str = "pool", resize: Optional[int] = 299,
                 device: Union[str, torch.device] = "cuda"):
        if feature not in inception.FEATURE_DIMS:
            raise ValueError(
                f"feature must be one of {list(inception.FEATURE_DIMS)}")
        self.device = torch.device(device)
        self.pretrained = weights_npz is not None
        params = (inception.load_npz(weights_npz) if weights_npz
                  else inception.init(torch.Generator().manual_seed(seed)))
        self.params = _on(params, self.device)
        self.feature = feature
        self.resize = resize

    def __call__(self, video: Video) -> np.ndarray:
        v = _video(video, self.device)
        if v.dim() == 5:                              # fold clips to frames
            v = v.reshape(-1, *v.shape[2:])
        with layers.exact_f32():
            return _host(inception.apply(self.params, v, self.feature,
                                         self.resize))


class C3DFeatures:
    """C3D extractor: (B, T, H, W, 3)[−1, 1] -> (B, D), the UCF-101 IS
    network (16-frame clips at 112²). Clips are windowed to 16 frames
    (the centre window when longer, loop-tiled when shorter); the
    protocol's mean and channel order come with the weights."""

    def __init__(self, weights_npz: Optional[str] = None, seed: int = 0,
                 feature: str = "logits", resize: Optional[int] = 112,
                 device: Union[str, torch.device] = "cuda"):
        if feature not in c3d.FEATURE_DIMS:
            raise ValueError(f"feature must be one of {list(c3d.FEATURE_DIMS)}")
        self.device = torch.device(device)
        self.pretrained = weights_npz is not None
        if weights_npz:
            params, self.input_mean, self.input_bgr = c3d.load_npz(weights_npz)
        else:
            params = c3d.init(torch.Generator().manual_seed(seed))
            self.input_mean, self.input_bgr = None, False
        self.params = _on(params, self.device)
        self.feature = feature
        self.resize = resize

    def __call__(self, video: Video) -> np.ndarray:
        v = _video(video, self.device)
        t, want = v.shape[1], c3d.CLIP_LEN
        if t > want:                                  # the centre window
            s = (t - want) // 2
            v = v[:, s:s + want]
        elif t < want:                                # loop-tile up to 16
            v = v.repeat(1, -(-want // t), 1, 1, 1)[:, :want]
        with layers.exact_f32():
            return _host(c3d.apply(self.params, v, self.feature, self.resize,
                                   self.input_mean, self.input_bgr))


class I3DLikeFeatures:
    """A 4-layer strided 3-D conv pyramid + global mean: (B, T, H, W, 3)
    -> (B, widths[-1]). `params["blocks"]` holds the reference's layout
    (DHWIO kernels, orthogonal init from `seed`'s generator), so the
    reference's weights can be carried over as they are."""

    def __init__(self, seed: int = 0, widths=(64, 128, 256, 512),
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(seed)
        blocks, cin = [], 3
        for w in widths:
            blocks.append({"w": winit.orthogonal(gen, (3, 3, 3, cin, w)),
                           "b": winit.zeros((w,))})
            cin = w
        self.params = {"blocks": [_on(b, self.device) for b in blocks]}

    def __call__(self, video: Video) -> np.ndarray:
        x = _video(video, self.device).permute(0, 4, 1, 2, 3)   # NCTHW
        with layers.exact_f32():
            for i, p in enumerate(self.params["blocks"]):
                # the reference's `layers.conv3d` with a stride, + bias
                t_stride = 2 if (i % 2 == 1 and x.shape[2] >= 2) else 1
                y = layers.conv(x, p["w"].permute(4, 3, 0, 1, 2),
                                (t_stride, 2, 2))
                x = torch.relu(y + p["b"].view(-1, 1, 1, 1))
            return _host(x.mean(dim=(2, 3, 4)))


def _softmax_np(logits: np.ndarray) -> np.ndarray:
    """Numerically stable softmax shared by the *ClassifierProbs."""
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


class C3DClassifierProbs:
    """(B, T, H, W, 3) -> (B, 101) softmax of C3D's UCF-101 logits, the
    published UCF-101 video-IS classifier. Random init when no weights
    (`pretrained` False)."""

    def __init__(self, weights_npz: Optional[str] = None, seed: int = 0,
                 feature_extractor: Optional[C3DFeatures] = None,
                 device: Union[str, torch.device] = "cuda"):
        if feature_extractor is not None:
            if feature_extractor.feature != "logits":
                raise ValueError("IS needs the logits head")
            self.fx = feature_extractor
        else:
            self.fx = C3DFeatures(weights_npz, seed, feature="logits",
                                  device=device)
        self.pretrained = self.fx.pretrained

    def from_features(self, logits: np.ndarray) -> np.ndarray:
        """Probs from logits already extracted (the shared-extractor eval:
        no second C3D forward a batch)."""
        return _softmax_np(logits)

    def __call__(self, video: Video) -> np.ndarray:
        return self.from_features(self.fx(video))


class I3DClassifierProbs:
    """(B, T, H, W, 3) -> (B, 400) softmax of I3D's Kinetics-400 logits,
    the published video-IS classifier (DVD-GAN's Kinetics protocol).
    Random init when no weights (`pretrained` False)."""

    def __init__(self, weights_npz: Optional[str] = None, seed: int = 0,
                 resize: Optional[int] = 224,
                 feature_extractor: Optional[I3DFeatures] = None,
                 device: Union[str, torch.device] = "cuda"):
        if feature_extractor is not None:            # one I3D on the card
            if feature_extractor.feature != "logits":
                raise ValueError("IS needs the 400-way logits head")
            self.fx = feature_extractor
        else:
            self.fx = I3DFeatures(weights_npz, seed, feature="logits",
                                  resize=resize, device=device)
        self.pretrained = self.fx.pretrained

    def from_features(self, logits: np.ndarray) -> np.ndarray:
        """Probs from logits already extracted (the shared-extractor eval:
        no second I3D forward a batch)."""
        return _softmax_np(logits)

    def __call__(self, video: Video) -> np.ndarray:
        return self.from_features(self.fx(video))


class ClassifierProbs:
    """(B, T, H, W, 3) -> (B, n_classes) softmax probs for IS: an
    orthogonal linear head (from `seed + 1`'s generator) over an
    `I3DLikeFeatures`."""

    def __init__(self, n_classes: int, seed: int = 0,
                 feature_extractor: Optional[I3DLikeFeatures] = None,
                 widths=(32, 64, 128, 256),
                 device: Union[str, torch.device] = "cuda"):
        self.fx = feature_extractor or I3DLikeFeatures(seed, widths=widths,
                                                       device=device)
        d = self.fx.params["blocks"][-1]["w"].shape[-1]
        head = linear_init(torch.Generator().manual_seed(seed + 1), d,
                           n_classes)
        self.head = _on(head, self.fx.device)

    def __call__(self, video: Video) -> np.ndarray:
        feats = torch.as_tensor(self.fx(video), dtype=torch.float32,
                                device=self.fx.device)
        with layers.exact_f32():
            return _host(F.softmax(linear(self.head, feats), dim=-1))
