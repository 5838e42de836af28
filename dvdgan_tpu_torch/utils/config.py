"""Config / CLI — the counterpart of `dvdgan_tpu/utils/config.py`.

The flag names, defaults and PRESETS are the reference's. `Config` carries
the fields the sample mode reads and every field a preset sets; the train
and eval fields arrive with the slices that port those modes. `--weights`
is the port's own: an npz written by `interop.save_state_npz`.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from dvdgan_tpu_torch.models import GConfig


@dataclasses.dataclass
class Config:
    # mode
    mode: str = "train"               # train | sample | eval
    n_samples: int = 16               # clips to generate in sample mode
    weights: str = ""                 # sample: EMA-G state npz (interop);
    #                                   empty = the seeded init
    # data
    dataset: str = "synthetic"        # synthetic | frames
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
    d_steps: int = 2
    ema_start: int = 1000
    total_step: int = 100000
    pretrained_model: Optional[int] = None   # resume from this step
    # runtime
    seed: int = 0
    bf16: bool = True
    out_dir: str = "runs/default"
    remat: bool = False               # rematerialize G levels (long clips)

    def g_config(self) -> GConfig:
        attn = self.attn_res if self.attn_res <= self.img_size // 2 else None
        return GConfig(img_size=self.img_size,
                       n_frames=self.n_frames - self.cond_frames,
                       ch=self.ch, z_dim=self.z_dim,
                       n_classes=self.n_classes, emb_dim=self.emb_dim,
                       attn_res=attn, remat=self.remat,
                       cond_frames=self.cond_frames)


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
