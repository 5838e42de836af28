"""CLI: `python -m dvdgan_tpu_torch --mode sample|train --preset ucf101_64
[--device cuda] [--weights state.npz] [--pretrained_model STEP] --out_dir
DIR ...` — the counterpart of the reference's `main.py`.

Both modes run on `--device` (default `cuda`); without a CUDA device the CLI
raises, unless `--device cpu` asks for the CPU.

Train mode is `train.trainer.Trainer(cfg).train()`: the state from --seed
(or --weights, a train-state npz, at its step), auto-resumed from the newest
checkpoint under DIR/checkpoints or from --pretrained_model <step>; steps
up to --total_step on synthetic clips (`dvdgan_tpu_torch.data`'s
SyntheticVideoDataset and Loader, numpy-only copies of the reference's: the
same batches the reference trainer draws for --seed); scalars, sample dumps
and checkpoints on the --log_step / --sample_step / --model_save_step
schedule (trainer.py). Each log line carries the four losses, steps/s and
the step's kernel launches (K1, K2, K3, K5a, K5b, K6a, K6b; K5a/K5b only
with `--ups_fused fwd|full`, which sends G's upsample convs through the
fused kernel, K6a/K6b only with `--attn_fused on`, which sends the
attention's spatial pass through its). After the loop, EMA-G samples of
the trainer's fixed z and y go to DIR/samples/<total_step>_grid.png and
GIFs, as the reference's main.py dumps them. `--grad_accum k` splits the
batch into k micro-batches per update, and a preset with `remat`
(kinetics_256_48f) rematerializes G's levels.

Sample mode takes EMA-G from the checkpoint --pretrained_model names, or
from --weights (an npz holding at least the EMA-G part; not both), or from
the newest checkpoint under DIR/checkpoints, or else the seeded init
(--seed). It draws z ∼ N(0, 1) and uniform class ids from a
torch.Generator seeded with --seed + 777 (the reference CLI's offset); for
DVD-GAN-FP (--cond_frames > 0) clip i is conditioned on the first
cond_frames frames of item i mod len of the --dataset, as the reference's
main.py does, and the clips are the frames generated after them. It
writes the clips as float32 (N, T, H, W, 3) in [-1, 1] to DIR/samples.npy,
their grid to DIR/samples/eval_<step>_grid.png and one GIF per clip.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dvdgan_tpu_torch import interop
from dvdgan_tpu_torch.models.generator import GeneratorState
from dvdgan_tpu_torch.train import checkpoint as ckpt
from dvdgan_tpu_torch.train import step
from dvdgan_tpu_torch.train.trainer import (Trainer, build_dataset,
                                            dataset_prefixes, resolve_device)
from dvdgan_tpu_torch.utils.config import Config, check_ported, parse_config
from dvdgan_tpu_torch.utils.media import save_batch_gifs, save_video_grid_png


def sample_state(cfg: Config) -> tuple[int, GeneratorState]:
    """(step, EMA-G state on the CPU) for sample mode."""
    if cfg.pretrained_model is not None and cfg.weights:
        raise ValueError("--pretrained_model and --weights both name the "
                         "weights to sample: pass one")
    ckpt_dir = os.path.join(cfg.out_dir, "checkpoints")
    step_no = cfg.pretrained_model
    if step_no is None and not cfg.weights:
        step_no = ckpt.latest_step(ckpt_dir)
    if step_no is not None:
        path = os.path.join(ckpt_dir, str(step_no), ckpt.STATE_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint at step {step_no}: {path}")
        return step_no, interop.load_state_npz(path)
    if cfg.weights:
        return 0, interop.load_state_npz(cfg.weights)
    return 0, GeneratorState.create(cfg.g_config(), cfg.seed)


def run_sample(cfg: Config, device: torch.device,
               state: GeneratorState) -> torch.Tensor:
    """EMA-G clips of `state` for cfg on `device`: (n_samples, T, H, W,
    3); for FP the frames generated after real prefixes of the dataset."""
    state = state.to(device)
    gen = torch.Generator().manual_seed(cfg.seed + 777)
    z = torch.randn(cfg.n_samples, cfg.z_dim, generator=gen)
    y = torch.randint(0, cfg.n_classes, (cfg.n_samples,), generator=gen)
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    cond = None
    if cfg.cond_frames > 0:
        cond = dataset_prefixes(build_dataset(cfg), cfg.cond_frames,
                                cfg.n_samples).to(device, dtype)
    return step.sample(*state.trees(), z.to(device, dtype), y.to(device),
                       cfg.g_config(), cond_video=cond)


def run_train(cfg: Config) -> dict:
    """Trains on the reference's schedule; returns the final state."""
    trainer = Trainer(cfg)
    try:
        metrics = trainer.train()
        print("final: " + " ".join(f"{k} {v:.6f}"
                                   for k, v in sorted(metrics.items())),
              flush=True)
        trainer.dump_samples(cfg.total_step)
    finally:
        trainer.close()
    return trainer.state


def main(argv=None):
    """Runs the mode; returns the clips (sample) or the final state
    (train)."""
    cfg = parse_config(argv)
    if cfg.mode not in ("sample", "train"):
        raise NotImplementedError(
            f"--mode {cfg.mode}: eval is ROADMAP Queue 1 item 5; this port "
            f"runs --mode sample and --mode train")
    if cfg.mode == "train":
        return run_train(cfg)
    check_ported(cfg)
    device = resolve_device(cfg.device)
    step_no, state = sample_state(cfg)
    videos = run_sample(cfg, device, state).float().cpu().numpy()
    os.makedirs(cfg.out_dir, exist_ok=True)
    out = os.path.join(cfg.out_dir, "samples.npy")
    np.save(out, videos)
    sample_dir = os.path.join(cfg.out_dir, "samples")
    save_video_grid_png(os.path.join(sample_dir, f"eval_{step_no}_grid.png"),
                        videos)
    save_batch_gifs(sample_dir, videos, step_no, max_n=cfg.n_samples)
    print(f"wrote {videos.shape[0]} samples {videos.shape} to {out} and "
          f"{sample_dir}")
    return videos
