#!/usr/bin/env python3
"""Where the port trainer's host time goes, at the flagship step (bf16,
batch 8, d_steps 2) on one GPU: ms per step of `Trainer.train()` and of
bare loops of `train.step.train_step`, timed in turns (each 10 steps after
the trainer's 2 of warm-up, two rounds, the second in reverse order):

  trainer            `Trainer.train()`, log_step 10, no save or dump
  trainer_loader1    the same with --loader_threads 1
  trainer_inline     the same with the next batch placed on the train
                     thread (no prefetch thread)
  bare_sync_data     the loader's batches, `.to(device)` on the train
                     thread, a synchronize after each step
  bare_nosync_data   the same, one synchronize at the end
  bare_sync_fixed    one batch on the card for every step, a synchronize
                     after each step (as `chip_smoke.time_train`)
  bare_nosync_fixed  the same, one synchronize at the end

then the data path alone (ms of the loader's `next` and of `_place` +
`_take` to a synchronize, 10 batches) and the host functions that take the
most time in 10 trainer steps and 10 bare steps (cProfile).

    python3 tools/torch_trainer_turns.py
"""

from __future__ import annotations

import cProfile
import io
import json
import os
import pstats
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (imports no part of the port)


class _Inline:
    """The trainer's prefetcher interface, run on the caller's thread."""

    def submit(self, fn):
        self.value = fn()
        return self

    def result(self):
        return self.value

    def shutdown(self):
        pass


def main() -> int:
    import torch

    from dvdgan_tpu_torch.kernels import _build
    from dvdgan_tpu_torch.train import step
    from dvdgan_tpu_torch.train import trainer as trainer_mod
    from dvdgan_tpu_torch.utils.config import parse_config

    if not torch.cuda.is_available():
        print("torch_trainer_turns: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.gpu_line(), flush=True)
    _build.build()
    tmp = tempfile.TemporaryDirectory()

    def make(name, *flags):
        cfg = parse_config(chip_smoke.FLAGSHIP_ARGV + [
            "--log_step", "10", "--sample_step", "0", "--model_save_step",
            "0", "--out_dir", os.path.join(tmp.name, name), *flags])
        tr = trainer_mod.Trainer(cfg)
        tr.train(total_step=2)
        return tr

    tr, tr1 = make("a"), make("b", "--loader_threads", "1")

    def trainer_ms(t, inline=False):
        prefetcher = trainer_mod._DaemonPrefetcher
        if inline:
            trainer_mod._DaemonPrefetcher = _Inline
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train(total_step=t.start_step + 10)
            return (time.perf_counter() - t0) / 10 * 1e3
        finally:
            trainer_mod._DaemonPrefetcher = prefetcher

    def bare_ms(sync_each, load):
        c = tr.cfg
        batches = tr.loader.forever(tr.start_step, 0)
        state, real, y = tr.state, None, None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            if load or real is None:
                clips, labels = next(batches)
                real = torch.from_numpy(clips).to(tr.device, tr.dtype)
                y = torch.from_numpy(labels).to(tr.device).long()
            draws = step.TorchDraws(c.seed, i, c.batch_size, tr.g_cfg.z_dim,
                                    tr.g_cfg.n_frames, tr.ds_cfg.k_frames,
                                    tr.dtype, tr.device)
            state, _ = step.train_step(state, real, y, draws, tr.g_cfg,
                                       tr.ds_cfg, tr.dt_cfg, tr.tc)
            if sync_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 10 * 1e3
        batches.close()
        tr.state = state
        return ms

    variants = {
        "trainer": lambda: trainer_ms(tr),
        "trainer_loader1": lambda: trainer_ms(tr1),
        "trainer_inline": lambda: trainer_ms(tr, inline=True),
        "bare_sync_data": lambda: bare_ms(True, True),
        "bare_nosync_data": lambda: bare_ms(False, True),
        "bare_sync_fixed": lambda: bare_ms(True, False),
        "bare_nosync_fixed": lambda: bare_ms(False, False)}
    turns: dict[str, list[float]] = {}
    for order in (list(variants), list(variants)[::-1]):
        for name in order:
            turns.setdefault(name, []).append(variants[name]())
            print(f"{name} {turns[name][-1]:.1f} ms/step", flush=True)

    batches, data = tr.loader.forever(0, 0), []
    for _ in range(10):
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        tr._take(tr._place(batch))
        torch.cuda.synchronize()
        data.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    batches.close()
    print("trainer_turns " + json.dumps(
        {"ms_per_step": turns, "data_path_ms_next_place": data}), flush=True)

    for name in ("trainer", "bare_sync_fixed"):
        prof = cProfile.Profile()
        prof.enable()
        variants[name]()
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(15)
        print(f"--- cProfile, 10 steps of {name}\n{out.getvalue()}",
              flush=True)
    tr.close()
    tr1.close()
    tmp.cleanup()
    print(chip_smoke.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
