"""CLI: `python -m dvdgan_tpu_torch --mode sample|train --preset ucf101_64
[--device cuda] [--weights state.npz] --out_dir DIR ...`.

Both modes run on `--device` (default `cuda`); without a CUDA device the CLI
raises, unless `--device cpu` asks for the CPU.

Sample mode draws z ∼ N(0, 1) and uniform class ids from a torch.Generator
seeded with --seed + 777 (the reference CLI's offset), runs EMA-G sampling
(`train.step.sample`) and writes the clips as float32 (N, T, H, W, 3) in
[-1, 1] to DIR/samples.npy. Without --weights the weights are the port's
seeded init (--seed).

Train mode builds the train state from --seed (or --weights, a train-state
npz, resuming at its step), takes --total_step steps of `train.step.
train_step` on synthetic clips (`dvdgan_tpu_torch.data`'s
SyntheticVideoDataset and Loader, numpy-only copies of the reference's: the
same batches the reference trainer draws for --seed), prints one line per
step with the four losses and the step's kernel launches (K1, K2, K3, K5a,
K5b, K6a, K6b; K5a/K5b only with `--ups_fused fwd|full`, which sends G's
upsample convs through the fused kernel, K6a/K6b only with `--attn_fused
on`, which sends the attention's spatial pass through its), and
writes the final state to DIR/train_state.npz (`interop` layout). The
step's own draws come from a torch.Generator on the device seeded with
--seed. `--grad_accum k` splits the batch into k micro-batches per update,
and a preset with `remat` (kinetics_256_48f) rematerializes G's levels.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from dvdgan_tpu_torch import interop, kernels
from dvdgan_tpu_torch.data import Loader, SyntheticVideoDataset
from dvdgan_tpu_torch.models.generator import GeneratorState
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step
from dvdgan_tpu_torch.utils.config import Config, parse_config


def resolve_device(name: str) -> torch.device:
    """The torch device `name` names; a CUDA device must exist."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           f"(pass --device cpu to run on the CPU)")
    return device


def run_sample(cfg: Config, device: torch.device) -> torch.Tensor:
    """EMA-G clips for cfg on `device`: (n_samples, T, H, W, 3)."""
    if cfg.pretrained_model is not None:
        raise NotImplementedError(
            "reading a dvdgan_tpu Orbax checkpoint is ROADMAP Queue 1 item 2; "
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


def _launch_counts() -> dict[str, int]:
    return {"k1": kernels.gru_sequence_fused.launches,
            "k2": kernels.convgru_bwd.gru_sequence_bwd.launches,
            "k3": kernels.gru_sequence_blocked.launches,
            "k5a": kernels.ups2x_fused.ups2x.launches,
            "k5b": kernels.ups2x_fused.ups2x_bwd.launches,
            "k6a": kernels.spatial_attn_fused.launches,
            "k6b": kernels.spatial_attn_tiled.launches}


def run_train(cfg: Config, device: torch.device) -> dict:
    """Takes cfg.total_step train steps on `device`; returns the state."""
    if cfg.pretrained_model is not None:
        raise NotImplementedError(
            "resuming from a dvdgan_tpu Orbax checkpoint is ROADMAP Queue 1 "
            "item 2; pass the state as an interop npz with --weights")
    if cfg.time_shards > 1:
        raise NotImplementedError(
            "time-axis context parallelism (--time_shards) is ROADMAP "
            "Queue 1 item 6")
    if cfg.dataset != "synthetic":
        raise NotImplementedError(
            f"--dataset {cfg.dataset}: the port trains on synthetic clips; "
            f"the frames pipeline is ROADMAP Queue 1 item 3")
    g_cfg, ds_cfg, dt_cfg = cfg.g_config(), cfg.ds_config(), cfg.dt_config()
    tc = cfg.train_config()
    state = (interop.load_train_state_npz(cfg.weights) if cfg.weights
             else train_state.create(cfg.seed, g_cfg, ds_cfg, dt_cfg))
    state = train_state.to_device(state, device)
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    draws = step.TorchDraws(
        torch.Generator(device).manual_seed(cfg.seed), cfg.batch_size,
        g_cfg.z_dim, g_cfg.n_frames, ds_cfg.k_frames, dtype)

    dataset = SyntheticVideoDataset(
        n_items=max(cfg.batch_size * 8, 64), n_frames=cfg.n_frames,
        img_size=cfg.img_size, n_classes=cfg.n_classes, seed=cfg.seed)
    loader = Loader(dataset, cfg.batch_size, seed=cfg.seed, num_threads=1)
    start = int(state["step"])
    per_epoch = loader.batches_per_epoch()
    batches = loader.forever(start // per_epoch, start % per_epoch)
    try:
        for clips, labels in itertools.islice(batches, cfg.total_step):
            real = torch.from_numpy(clips).to(device, dtype)
            y = torch.from_numpy(labels).to(device).long()
            before = _launch_counts()
            state, metrics = step.train_step(state, real, y, draws, g_cfg,
                                             ds_cfg, dt_cfg, tc)
            launches = " ".join(f"{k}_launches {n - before[k]}"
                                for k, n in _launch_counts().items())
            losses = " ".join(f"{k} {float(v):.6f}"
                              for k, v in metrics.items())
            print(f"step {int(state['step'])} {losses} {launches}",
                  flush=True)
    finally:
        batches.close()
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"peak device memory {peak:.3f} GiB", flush=True)
    os.makedirs(cfg.out_dir, exist_ok=True)
    out = os.path.join(cfg.out_dir, "train_state.npz")
    interop.save_train_state_npz(out, state)
    print(f"wrote the train state at step {int(state['step'])} to {out}")
    return state


def main(argv=None):
    """Runs the mode; returns the clips (sample) or the final state
    (train)."""
    cfg = parse_config(argv)
    if cfg.mode not in ("sample", "train"):
        raise NotImplementedError(
            f"--mode {cfg.mode}: eval is ROADMAP Queue 1 item 5; this port "
            f"runs --mode sample and --mode train")
    device = resolve_device(cfg.device)
    if cfg.mode == "train":
        return run_train(cfg, device)
    videos = run_sample(cfg, device).float().cpu().numpy()
    os.makedirs(cfg.out_dir, exist_ok=True)
    out = os.path.join(cfg.out_dir, "samples.npy")
    np.save(out, videos)
    print(f"wrote {videos.shape[0]} samples {videos.shape} to {out}")
    return videos
