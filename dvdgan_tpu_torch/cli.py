"""CLI: `python -m dvdgan_tpu_torch --mode sample --preset ucf101_64
--n_samples 16 --bf16 1 --out_dir DIR [--weights state.npz]`.

Sample mode draws z ∼ N(0, 1) and uniform class ids from a torch.Generator
seeded with --seed + 777 (the reference CLI's offset), runs EMA-G sampling
(`train.step.sample`) on the GPU when there is one, and writes the clips as
float32 (N, T, H, W, 3) in [-1, 1] to DIR/samples.npy. Without --weights the
weights are the port's seeded init (--seed).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dvdgan_tpu_torch import interop
from dvdgan_tpu_torch.models.generator import GeneratorState
from dvdgan_tpu_torch.train import step
from dvdgan_tpu_torch.utils.config import Config, parse_config


def run_sample(cfg: Config, device: torch.device) -> torch.Tensor:
    """EMA-G clips for cfg on `device`: (n_samples, T, H, W, 3)."""
    if cfg.pretrained_model is not None:
        raise NotImplementedError(
            "reading a dvdgan_tpu Orbax checkpoint is ROADMAP Queue 1 item 8; "
            "restore it with dvdgan_tpu, np.savez its flattened g_ema, "
            "g/stats and g/sn_u leaves (see interop.py) and pass --weights")
    g_cfg = cfg.g_config()
    state = (interop.load_state_npz(cfg.weights) if cfg.weights
             else GeneratorState.create(g_cfg, cfg.seed)).to(device)
    gen = torch.Generator().manual_seed(cfg.seed + 777)
    z = torch.randn(cfg.n_samples, cfg.z_dim, generator=gen)
    y = torch.randint(0, cfg.n_classes, (cfg.n_samples,), generator=gen)
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    return step.sample(*state.trees(), z.to(device, dtype), y.to(device),
                       g_cfg)


def main(argv=None) -> np.ndarray:
    cfg = parse_config(argv)
    if cfg.mode != "sample":
        raise NotImplementedError(
            f"--mode {cfg.mode}: train is ROADMAP Queue 1 items 6-8 and eval "
            f"item 11; this port runs --mode sample")
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    videos = run_sample(cfg, device).float().cpu().numpy()
    os.makedirs(cfg.out_dir, exist_ok=True)
    out = os.path.join(cfg.out_dir, "samples.npy")
    np.save(out, videos)
    print(f"wrote {videos.shape[0]} samples {videos.shape} to {out}")
    return videos
