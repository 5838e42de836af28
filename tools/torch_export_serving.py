#!/usr/bin/env python3
"""Export the port's EMA-G sampler as a `torch.export` artifact — the
counterpart of `tools/export_serving.py`.

The artifact (`dvdgan_tpu_torch/serving.py`) bakes in the SN-normalized
EMA weights and G's BN running statistics, holds the kernels as the
registered `dvdgan::` ops, and runs without the port's model code:

    from dvdgan_tpu_torch.serving import load_sampler
    serve = load_sampler("g_sampler.pt2")   # imports torch and the ops
    clips = serve(z, y)      # z (B, z_dim) f32, y (B,) int64 on the
    #                          artifact's device -> (B, T, H, W, 3) f32
    # DVD-GAN-FP artifacts also take cond (B, cond_frames, H, W, 3) f32

Usage:
  python tools/torch_export_serving.py --preset ucf101_64 --out_dir runs/ucf \
      [--pretrained_model N | --weights state.npz] --export_path g.pt2 \
      [--serve_batch 8] [--serve_dtype float32|bfloat16] [--device cuda]

Any model flag of the port's CLI pins the architecture (`--ups_fused`,
`--attn_fused` pick the kernels that go in); the weights are found as
`--mode sample` finds them (the checkpoint --pretrained_model names,
--weights, the newest checkpoint under --out_dir, else the seeded init).
`--serve_batch 0` exports one batch-polymorphic program. The artifact is
specific to `--device` (default `cuda`): on the CPU its ops run the
kernels' plain versions.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> str:
    import torch

    from dvdgan_tpu_torch import serving
    from dvdgan_tpu_torch.cli import sample_state
    from dvdgan_tpu_torch.train.trainer import resolve_device
    from dvdgan_tpu_torch.utils import config as config_mod

    parser = config_mod.build_parser()
    parser.add_argument("--export_path", required=True,
                        help="output file for the artifact")
    parser.add_argument("--serve_batch", type=int, default=8,
                        help="clips per serving request (baked shape); "
                             "0 = batch-polymorphic artifact")
    parser.add_argument("--serve_dtype", default="float32",
                        choices=sorted(serving.DTYPES),
                        help="weight and compute dtype baked into the "
                             "artifact (the interface stays f32)")
    args = parser.parse_args(argv)
    cfg = config_mod.config_from_args(args)
    device = resolve_device(cfg.device)
    step_no, state = sample_state(cfg)
    if step_no:
        print(f"exporting checkpoint step {step_no}")
    elif cfg.weights:
        print(f"exporting {cfg.weights}")
    else:
        print("WARNING: no checkpoint found — exporting the seeded init")
    program = serving.export_sampler(state, cfg.g_config(), args.serve_batch,
                                     device, args.serve_dtype)
    torch.export.save(program, args.export_path)
    print(f"wrote {os.path.getsize(args.export_path)} bytes to "
          f"{args.export_path} (batch {args.serve_batch or 'any'}, "
          f"{args.serve_dtype}, {device}; ops "
          f"{serving.op_counts(program)})", flush=True)
    return args.export_path


if __name__ == "__main__":
    main()
