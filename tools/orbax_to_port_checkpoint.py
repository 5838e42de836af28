"""Convert a dvdgan_tpu (Orbax) checkpoint into a dvdgan_tpu_torch one.

    python tools/orbax_to_port_checkpoint.py --preset ucf101_64 \\
        --out_dir runs/ucf [--pretrained_model STEP] --port_out_dir runs/port

Restores the reference's train state at STEP (default: its newest) from
<out_dir>/checkpoints with `dvdgan_tpu.train.checkpoint.restore`, and
writes it as the port's checkpoint <port_out_dir>/checkpoints/<STEP>/
(`dvdgan_tpu_torch.train.checkpoint`: the `interop` flat layout, whose
paths are the reference's `flatten_with_paths`). Then

    python -m dvdgan_tpu_torch --mode train --preset ucf101_64 \\
        --out_dir runs/port [--pretrained_model STEP] ...

resumes it (it is also the newest checkpoint there), and `--mode sample`
samples it. The model flags must match the checkpoint's architecture, as
for resuming. Runs where jax and orbax are installed; the port itself
needs neither.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(ckpt_dir: str, step: int, template, port_out_dir: str) -> str:
    """Writes the reference checkpoint `ckpt_dir/<step>` (restored into
    `template`, a reference train state or its `jax.eval_shape`) as a port
    checkpoint; -> its directory."""
    import numpy as np

    from dvdgan_tpu.core import tree as jtree
    from dvdgan_tpu.train import checkpoint as ref_ckpt
    from dvdgan_tpu_torch import interop
    from dvdgan_tpu_torch.train import checkpoint as port_ckpt

    state = ref_ckpt.restore(ckpt_dir, step, template)
    flat = {k: np.asarray(v) for k, v in
            jtree.flatten_with_paths(state).items()}
    port_dir = os.path.join(port_out_dir, "checkpoints")
    port_ckpt.save(port_dir, step, interop.load_train_state(flat))
    return os.path.join(port_dir, str(step))


def main(argv=None) -> str:
    import jax

    from dvdgan_tpu.train import checkpoint as ref_ckpt
    from dvdgan_tpu.train import state as train_state
    from dvdgan_tpu.utils import config as config_mod

    parser = config_mod.build_parser()
    parser.add_argument("--port_out_dir", required=True)
    args = parser.parse_args(argv)
    cfg = config_mod.config_from_args(args)
    ckpt_dir = os.path.join(cfg.out_dir, "checkpoints")
    step = cfg.pretrained_model
    if step is None:
        step = ref_ckpt.latest_step(ckpt_dir)
        if step is None:
            raise SystemExit(f"no checkpoints under {ckpt_dir}")
    # the tree's structure, shapes and dtypes only: no init is computed
    template = jax.eval_shape(
        lambda key: train_state.create(key, cfg.g_config(), cfg.ds_config(),
                                       cfg.dt_config(), cfg.train_config()),
        jax.random.PRNGKey(0))
    out = convert(ckpt_dir, step, template, args.port_out_dir)
    print(f"converted step {step} of {ckpt_dir} -> {out}")
    return out


if __name__ == "__main__":
    main()
