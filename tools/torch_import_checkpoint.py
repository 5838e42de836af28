#!/usr/bin/env python3
"""Import PyTorch DVD-GAN state dicts into a port checkpoint — the
counterpart of `tools/import_torch_checkpoint.py`, on torch and numpy
alone (no jax).

Takes G, DS and DT state dicts (and optionally EMA-G's) in the
interchange naming (`dvdgan_tpu_torch/migrate.py`), converts them into the
port's trees (`migrate.to_port`: strict, a missing, extra or misshaped
key raises and names it; bf16/f16 tensors are cast to f32) and writes the
whole train state (`migrate.build_state`: fresh Adam, EMA from G unless
--g_ema_ckpt, the step, SN u converged by --sn_warmup power iterations)
as the port's checkpoint <out_dir>/checkpoints/<step>/:

  python tools/torch_import_checkpoint.py --preset ucf101_64 \\
      --g_ckpt G.pth [--g_ema_ckpt G_ema.pth] --ds_ckpt DS.pth \\
      --dt_ckpt DT.pth --out_dir runs/imported [--step 0] [--sn_warmup 30]

Then `python -m dvdgan_tpu_torch --mode train --preset ucf101_64 --out_dir
runs/imported --pretrained_model <step>` resumes it and `--mode sample`
samples it. Inputs: .pth/.pt (`torch.load(weights_only=True)`, a
{"state_dict": ...} container unwrapped) or .npz; spectral-norm wrapper
keys (`weight_orig`, `weight_u`, `weight_v`) are handled. Every model flag
of the port's CLI pins the architecture the state dicts must match.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> str:
    from dvdgan_tpu_torch import migrate
    from dvdgan_tpu_torch.train import checkpoint
    from dvdgan_tpu_torch.utils import config as config_mod

    parser = config_mod.build_parser()
    parser.add_argument("--g_ckpt", required=True,
                        help="G state dict (.pth/.pt/.npz)")
    parser.add_argument("--ds_ckpt", required=True)
    parser.add_argument("--dt_ckpt", required=True)
    parser.add_argument("--g_ema_ckpt", default="",
                        help="EMA-G state dict (default: a copy of G)")
    parser.add_argument("--step", type=int, default=0, dest="import_step",
                        help="the step the checkpoint is stored under")
    parser.add_argument("--sn_warmup", type=int, default=30,
                        help="power iterations that converge the fresh SN u")
    args = parser.parse_args(argv)
    cfg = config_mod.config_from_args(args)
    g_cfg, ds_cfg, dt_cfg = cfg.g_config(), cfg.ds_config(), cfg.dt_config()
    g_params, g_stats, ds_params, dt_params = migrate.to_port(
        migrate.load_state_dict(args.g_ckpt),
        migrate.load_state_dict(args.ds_ckpt),
        migrate.load_state_dict(args.dt_ckpt), g_cfg, ds_cfg, dt_cfg)
    g_ema = None
    if args.g_ema_ckpt:
        g_ema, _ = migrate.generator_to_port(
            migrate.load_state_dict(args.g_ema_ckpt), g_cfg)
    state = migrate.build_state(cfg, g_params, g_stats, ds_params, dt_params,
                                g_ema=g_ema, step=args.import_step,
                                sn_warmup=args.sn_warmup)
    ckpt_dir = os.path.join(cfg.out_dir, "checkpoints")
    checkpoint.save(ckpt_dir, args.import_step, state)
    print(f"imported checkpoint -> {ckpt_dir}/{args.import_step} (resume "
          f"with --out_dir {cfg.out_dir} --pretrained_model "
          f"{args.import_step})", flush=True)
    return ckpt_dir


if __name__ == "__main__":
    main()
