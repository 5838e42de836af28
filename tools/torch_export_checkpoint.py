#!/usr/bin/env python3
"""Export a port checkpoint as PyTorch state dicts — the counterpart of
`tools/export_torch_checkpoint.py`, on torch and numpy alone (no jax).

Restores the port's train state at --pretrained_model (default: the
newest step) from <out_dir>/checkpoints against the config's trees
(`train.checkpoint.restore`: strict) and writes
<export_dir>/{G,G_ema,DS,DT}.pth in the interchange naming
(`dvdgan_tpu_torch/migrate.py`, `migrate.from_port`: float32, contiguous,
BN's num_batches_tracked included), which loads with strict=True into
any PyTorch implementation of that layout:

  python tools/torch_export_checkpoint.py --preset ucf101_64 \\
      --out_dir runs/ucf [--pretrained_model 100000] --export_dir DIR

Model flags must match the checkpoint's architecture, as for resuming.
`tools/torch_import_checkpoint.py` takes the files back bitwise.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> list[str]:
    import torch

    from dvdgan_tpu_torch import migrate
    from dvdgan_tpu_torch.train import checkpoint
    from dvdgan_tpu_torch.train import state as train_state
    from dvdgan_tpu_torch.utils import config as config_mod

    parser = config_mod.build_parser()
    parser.add_argument("--export_dir", required=True)
    args = parser.parse_args(argv)
    cfg = config_mod.config_from_args(args)
    g_cfg, ds_cfg, dt_cfg = cfg.g_config(), cfg.ds_config(), cfg.dt_config()
    ckpt_dir = os.path.join(cfg.out_dir, "checkpoints")
    step = cfg.pretrained_model
    if step is None:
        step = checkpoint.latest_step(ckpt_dir)
        if step is None:
            raise SystemExit(f"no checkpoints under {ckpt_dir}")
    state = checkpoint.restore(ckpt_dir, step, train_state.create(
        cfg.seed, g_cfg, ds_cfg, dt_cfg))
    os.makedirs(args.export_dir, exist_ok=True)
    written = []
    for name, sd in migrate.from_port(state, g_cfg, ds_cfg, dt_cfg).items():
        path = os.path.join(args.export_dir, f"{name}.pth")
        torch.save(sd, path)
        written.append(path)
    print(f"exported step {step} -> " + ", ".join(written), flush=True)
    return written


if __name__ == "__main__":
    main()
