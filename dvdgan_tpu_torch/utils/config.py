"""Config / CLI — the counterpart of `dvdgan_tpu/utils/config.py`.

The flag names, defaults and PRESETS are the reference's, and `Config` has
every field of the reference's. `--n_devices`, `--time_shards` and
`--multihost` take train mode over several ranks (`parallel/mesh.py`,
`cli.py`).
`--ups_fused {off,fwd,full}` is the reference's environment variable
DVDGAN_UPS_PALLAS as a flag (the route of G's upsample convs,
`ops/layers.py`), and `--attn_fused {off,on}` its DVDGAN_ATTN_PALLAS (the
route of the attention's spatial pass, `ops/attention.py`), and
`--remat_save {none,gru,ups,gru+ups}` its DVDGAN_REMAT_SAVE (what each
level's remat region keeps, `models/generator.py`). `--weights`
and `--device` are the port's own: `--weights` is an npz written by
`interop` (sample: any state holding the EMA-G part; train: a whole train
state to start from), and `--device` names the torch device, `cuda` by
default; without a CUDA device the CLI raises rather than run elsewhere,
unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from dvdgan_tpu_torch.models import DSConfig, DTConfig, GConfig
from dvdgan_tpu_torch.models.config import REMAT_SAVE_MODES
from dvdgan_tpu_torch.ops.attention import ATTN_FUSED_MODES
from dvdgan_tpu_torch.ops.layers import UPS_FUSED_MODES
from dvdgan_tpu_torch.train.state import TrainConfig


@dataclasses.dataclass
class Config:
    # mode
    mode: str = "train"               # train | sample | eval
    n_samples: int = 16               # clips to generate (sample) or to
    #                                   score (eval)
    weights: str = ""                 # state npz (interop); empty = the
    #                                   seeded init
    i3d_weights: str = ""             # I3D npz in the reference's layout
    #                                   (tools/convert_i3d_weights.py);
    #                                   empty = a random init, labelled not
    #                                   published-comparable
    inception_weights: str = ""       # Inception-v3 npz (frame FID)
    c3d_weights: str = ""             # C3D npz (the UCF-101 IS protocol)
    is_protocol: str = "i3d"          # the IS classifier: i3d | c3d
    real_stats: str = ""              # --mode eval: npz of the real side's
    #                                   features; computed and written
    #                                   there when missing
    # data
    dataset: str = "synthetic"        # synthetic | frames
    data_path: str = ""               # root of the frame folders
    npy_range: str = "auto"           # float .npy clips: auto | unit |
    #                                   symmetric
    loader_threads: int = 2           # the loader's decode threads
    prefetch: int = 2                 # ready batches queued ahead
    n_classes: int = 101
    # model
    img_size: int = 64
    n_frames: int = 16                # clip length; with cond_frames > 0,
    #                                   G generates n_frames - cond_frames
    cond_frames: int = 0              # DVD-GAN-FP: real prefix length
    z_dim: int = 120
    ch: int = 32
    d_ch: int = 32
    emb_dim: int = 120
    attn_res: int = 32
    k_frames: int = 8
    # optimization
    batch_size: int = 32
    lr_g: float = 1e-4
    lr_d: float = 5e-4
    beta1: float = 0.0
    beta2: float = 0.999
    d_steps: int = 2
    grad_accum: int = 1               # micro-batches per update
    fake_gen: str = "pooled"          # pooled | per_step
    log_grad_norms: bool = False      # g/d_grad_norm in the metrics
    log_sigmas: bool = False          # SN σ and attention γ scalars at
    #                                   sample_step
    ema_decay: float = 0.9999
    ema_start: int = 1000
    total_step: int = 100000
    steps_per_call: int = 1           # K > 1: K steps a call (a CUDA
    #                                   graph on the card)
    # schedule
    log_step: int = 10
    sample_step: int = 500
    model_save_step: int = 1000
    keep_checkpoints: int = 0         # > 0: keep only the newest N
    async_save: bool = True           # write checkpoints on a thread (the
    #                                   snapshot stays on the train thread)
    eval_step: int = 0                # > 0: FVD/IS of EMA-G every N
    #                                   steps (Trainer.evaluate)
    eval_samples: int = 64
    eval_repeats: int = 1             # --mode eval: N fake sets, one real
    #                                   side -> mean and *_std
    pretrained_model: Optional[int] = None   # resume from this step
    # runtime
    n_devices: int = 0                # ranks of one launch; 0: every
    #                                   visible card (one on the CPU)
    seed: int = 0
    bf16: bool = True
    out_dir: str = "runs/default"
    profile: bool = False             # torch.profiler trace of steps 10..15
    nan_check: bool = False           # anomaly mode, losses checked a step
    remat: bool = False               # rematerialize G levels (long clips)
    multihost: bool = False           # ranks from the launcher's env
    time_shards: int = 1              # >1: DT context-parallel over time
    device: str = "cuda"              # torch device (cuda | cuda:N | cpu)
    ups_fused: str = "off"            # G's upsample convs: off | fwd | full
    attn_fused: str = "off"           # G's spatial attention: off | on
    remat_save: str = "gru+ups"       # what remat keeps: none | gru | ups |
    #                                   gru+ups

    def g_config(self) -> GConfig:
        attn = self.attn_res if self.attn_res <= self.img_size // 2 else None
        return GConfig(img_size=self.img_size,
                       n_frames=self.n_frames - self.cond_frames,
                       ch=self.ch, z_dim=self.z_dim,
                       n_classes=self.n_classes, emb_dim=self.emb_dim,
                       attn_res=attn, remat=self.remat,
                       cond_frames=self.cond_frames,
                       ups_fused=self.ups_fused,
                       attn_fused=self.attn_fused,
                       remat_save=self.remat_save)

    def ds_config(self) -> DSConfig:
        return DSConfig(img_size=self.img_size, ch=self.d_ch,
                        n_classes=self.n_classes,
                        k_frames=min(self.k_frames,
                                     self.n_frames - self.cond_frames))

    def dt_config(self) -> DTConfig:
        return DTConfig(img_size=self.img_size, n_frames=self.n_frames,
                        ch=self.d_ch, n_classes=self.n_classes)

    def train_config(self) -> TrainConfig:
        return TrainConfig(lr_g=self.lr_g, lr_d=self.lr_d, beta1=self.beta1,
                           beta2=self.beta2, d_steps=self.d_steps,
                           ema_decay=self.ema_decay,
                           ema_start=self.ema_start,
                           grad_accum=self.grad_accum,
                           fake_gen=self.fake_gen,
                           log_grad_norms=self.log_grad_norms)


# The reference's five named configs, unchanged.
PRESETS: dict[str, dict] = {
    "smoke": dict(dataset="synthetic", img_size=64, n_frames=8, ch=16,
                  d_ch=16, batch_size=4, n_classes=10, d_steps=1,
                  total_step=1, attn_res=32, k_frames=4, ema_start=0),
    "ucf101_64": dict(dataset="frames", img_size=64, n_frames=16,
                      n_classes=101, batch_size=32, attn_res=32),
    "kinetics_64": dict(dataset="frames", img_size=64, n_frames=12,
                        n_classes=600, batch_size=32, attn_res=32),
    "kinetics_128": dict(dataset="frames", img_size=128, n_frames=12,
                         n_classes=600, batch_size=64, attn_res=32),
    # z_dim=112: 256px has 6 levels -> 7 latent chunks (112 = 7·16)
    "kinetics_256_48f": dict(dataset="frames", img_size=256, n_frames=48,
                             n_classes=600, batch_size=512, attn_res=32,
                             remat=True, z_dim=112),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "dvdgan_tpu_torch",
        description="DVD-GAN in PyTorch for the H100 (reference CLI parity)")
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    for f in dataclasses.fields(Config):
        arg = f"--{f.name}"
        if isinstance(f.default, bool):
            p.add_argument(arg, type=lambda s: s.lower() in ("1", "true", "t"),
                           default=None)
        elif f.name == "pretrained_model":
            p.add_argument(arg, type=int, default=None)
        elif f.name == "ups_fused":
            p.add_argument(arg, choices=UPS_FUSED_MODES, default=None)
        elif f.name == "attn_fused":
            p.add_argument(arg, choices=ATTN_FUSED_MODES, default=None)
        elif f.name == "remat_save":
            p.add_argument(arg, choices=REMAT_SAVE_MODES, default=None)
        elif f.name == "mode":
            p.add_argument(arg, choices=("train", "sample", "eval"),
                           default=None)
        elif f.name == "is_protocol":
            p.add_argument(arg, choices=("i3d", "c3d"), default=None)
        else:
            typ = {int: int, float: float, str: str}.get(type(f.default), str)
            p.add_argument(arg, type=typ, default=None)
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    """Preset base + explicit overrides."""
    base: dict = {}
    if args.preset:
        base.update(PRESETS[args.preset])
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name)
        if v is not None:
            base[f.name] = v
    return Config(**base)


def parse_config(argv=None) -> Config:
    return config_from_args(build_parser().parse_args(argv))
