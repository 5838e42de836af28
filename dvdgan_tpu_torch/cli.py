"""CLI: `python -m dvdgan_tpu_torch --mode sample|train|eval --preset
ucf101_64 [--device cuda] [--weights state.npz] [--pretrained_model STEP]
--out_dir DIR ...` — the counterpart of the reference's `main.py`.

Every mode runs on `--device` (default `cuda`); without a CUDA device the
CLI raises, unless `--device cpu` asks for the CPU.

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

Train mode over several ranks (`parallel/mesh.py`): `--n_devices N`
spawns the ranks of one launch (one per visible card, or N gloo ranks on
the CPU with `--device cpu`), `--time_shards n` splits them into data ×
time ranks (DT context-parallel over the clip), and `--multihost` makes
this process one rank of a cluster whose launcher set RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT (two such processes on one card
run over gloo). `--batch_size` is the global batch. A rank that fails
stops the launch with an error. Sample and eval modes run in one process.

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

Eval mode scores --n_samples EMA-G clips of `Trainer(cfg)` (auto-resumed,
or from --pretrained_model or --weights, as in train mode) against the
dataset's first clips, as the reference's main.py does: FVD with I3D
(`eval.I3DFeatures`, --i3d_weights), frame FID with Inception-v3
(--inception_weights) and the video IS of --is_protocol i3d (softmax of the
FVD extractor's own logits) or c3d (C3D, --c3d_weights). The weights are
npz files in the reference's layout (tools/convert_*_weights.py write
them where JAX runs); without them the networks run at a seeded random
init and the result says `*_published_comparable: false`. --real_stats
PATH keeps the real side's features in an npz, checked against the run's
dataset, size and extractors when read; --eval_repeats R scores R fake
sets (sample seeds 1234 + 1000·r) against one real side and reports their
mean and *_std. It prints the kernel launches, the wall time (the
sampling's share apart) and the peak device memory, then one JSON line
with the reference's keys.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from dvdgan_tpu_torch import interop
from dvdgan_tpu_torch.eval import (C3DClassifierProbs, I3DClassifierProbs,
                                   I3DFeatures, InceptionFeatures,
                                   compute_real_features, evaluate_generator,
                                   file_stamp, load_or_compute_real_stats)
from dvdgan_tpu_torch.models.generator import GeneratorState
from dvdgan_tpu_torch.parallel import mesh as pmesh
from dvdgan_tpu_torch.train import checkpoint as ckpt
from dvdgan_tpu_torch.train import step
from dvdgan_tpu_torch.train.trainer import (Trainer, build_dataset,
                                            dataset_prefixes, launch_counts,
                                            resolve_device)
from dvdgan_tpu_torch.utils.config import Config, parse_config
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


def _train(cfg: Config, par=None) -> dict:
    trainer = Trainer(cfg, par)
    try:
        metrics = trainer.train()
        if trainer.is_main:
            print("final: " + " ".join(f"{k} {v:.6f}"
                                       for k, v in sorted(metrics.items())),
                  flush=True)
        trainer.dump_samples(cfg.total_step)
    finally:
        trainer.close()
    return trainer.state


def train_rank(local_rank: int, cfg: Config) -> None:
    """One rank of a `--n_devices` launch (`pmesh.spawn` sets its
    environment): on cuda:<local_rank>, or the CPU."""
    device = (torch.device("cuda", local_rank)
              if torch.device(cfg.device).type == "cuda"
              else torch.device("cpu"))
    par = pmesh.init_from_env(device, cfg.time_shards, cfg.batch_size)
    try:
        _train(cfg, par)
    finally:
        par.close()


def run_train(cfg: Config) -> Optional[dict]:
    """Trains on the reference's schedule; returns the final state of a
    run in this process (one rank, or this rank of `--multihost`), None
    when `--n_devices` ran the ranks in child processes."""
    device = resolve_device(cfg.device)
    if cfg.multihost:
        if cfg.n_devices > 0:
            raise ValueError("--n_devices starts the ranks of one launch; "
                             "under --multihost the launcher starts one "
                             "process a rank")
        par = pmesh.init_from_env(device, cfg.time_shards, cfg.batch_size)
        try:
            return _train(cfg, par)
        finally:
            par.close()
    n_data, n_time = pmesh.plan(cfg.n_devices, cfg.time_shards,
                                cfg.batch_size, device)
    world = n_data * n_time
    if world == 1:
        return _train(dataclasses.replace(cfg, n_devices=1), None)
    pmesh.spawn(train_rank, world, (cfg,))
    return None


def run_eval(cfg: Config) -> dict:
    """FVD, frame FID and video IS of EMA-G as the reference's main.py
    computes them; -> the result dict, also printed as the last line."""
    t0 = time.perf_counter()
    trainer = Trainer(cfg)
    try:
        device = trainer.device
        fx = I3DFeatures(cfg.i3d_weights or None, seed=0, device=device)
        fx2d = InceptionFeatures(cfg.inception_weights or None, seed=0,
                                 device=device)
        if cfg.is_protocol == "c3d":     # the published UCF-101 IS
            clf = C3DClassifierProbs(cfg.c3d_weights or None, seed=0,
                                     device=device)
        else:                            # Kinetics IS over fx's own logits
            clf = I3DClassifierProbs(feature_extractor=fx)
        # the identity tags key both the cache's stamps and the result
        fx_tag = "i3d-kinetics400" if fx.pretrained else "i3d-random-init"
        fx2d_tag = ("inception-v3" if fx2d.pretrained
                    else "inception-v3-random-init")
        n = min(cfg.n_samples, len(trainer.dataset))
        batch = min(cfg.batch_size, n)
        timing = {"sample_s": 0.0}
        t1 = time.perf_counter()
        before = launch_counts()
        real_features = None
        if cfg.real_stats:
            meta = {
                "dataset": cfg.dataset, "data_path": cfg.data_path,
                "npy_range": cfg.npy_range,
                # both datasets draw clip content or windows from the seed
                "seed": cfg.seed, "n_classes": cfg.n_classes,
                "img_size": cfg.img_size, "n_frames": cfg.n_frames, "n": n,
                "extractor": fx_tag,
                # a reconverted weights file is another feature space
                "extractor_weights": file_stamp(cfg.i3d_weights),
                "frame_extractor": fx2d_tag,
                "frame_extractor_weights": file_stamp(cfg.inception_weights),
            }
            real_features = load_or_compute_real_stats(
                cfg.real_stats, trainer.dataset, fx, n, batch_size=batch,
                frame_extractor=fx2d, meta=meta)
            print(f"real stats: {cfg.real_stats}", flush=True)
        repeats = max(1, cfg.eval_repeats)
        if real_features is None and repeats > 1:   # one real side for all
            real_features = compute_real_features(
                trainer.dataset, fx, n, batch_size=batch,
                frame_extractor=fx2d)
        runs = [evaluate_generator(trainer, fx, n_samples=cfg.n_samples,
                                   classifier=clf, frame_extractor=fx2d,
                                   real_features=real_features,
                                   sample_seed=1234 + 1000 * r,
                                   timing=timing)
                for r in range(repeats)]
        t2 = time.perf_counter()
        print("eval_launches " + json.dumps(
            {k: v - before[k] for k, v in launch_counts().items()}))
        peak = (torch.cuda.max_memory_allocated(device) / 2**30
                if device.type == "cuda" else None)
        print("eval_time " + json.dumps(
            {"setup_s": t1 - t0, "eval_s": t2 - t1,
             "sample_s": timing["sample_s"], "peak_mem_gib": peak}))
        out = dict(runs[0])
        if repeats > 1:
            for k in ("fvd", "fid", "is_mean"):
                if k in runs[0]:
                    vals = [r[k] for r in runs]
                    out[k] = float(np.mean(vals))
                    out[k + "_std"] = float(np.std(vals))
            out["eval_repeats"] = repeats
        out["extractor"] = fx_tag
        out["fvd_published_comparable"] = fx.pretrained
        out["is_classifier"] = (
            ("c3d-ucf101" if clf.pretrained else "c3d-random-init")
            if cfg.is_protocol == "c3d" else
            ("i3d-kinetics400" if clf.pretrained else "i3d-random-init"))
        out["is_published_comparable"] = clf.pretrained
        out["frame_extractor"] = fx2d_tag
        out["fid_published_comparable"] = fx2d.pretrained
        print(json.dumps(out), flush=True)
        return out
    finally:
        trainer.close()


def main(argv=None):
    """Runs the mode; returns the clips (sample), the final state (train)
    or the result dict (eval)."""
    cfg = parse_config(argv)
    if cfg.mode == "train":
        return run_train(cfg)
    if cfg.mode == "eval":
        return run_eval(cfg)
    if cfg.multihost or cfg.time_shards > 1 or cfg.n_devices > 1:
        raise ValueError("--mode sample runs in one process: drop "
                         "--multihost, --time_shards and --n_devices")
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
