"""Checkpoint / resume — the counterpart of `dvdgan_tpu/train/checkpoint.py`.

A checkpoint is the whole train state (params, Adam moments and counts, EMA
params, SN u, BN running stats, step) under `ckpt_dir/<step>/`, in the
port's own format: `train_state.npz`, the `interop` flat layout (the
reference's `flatten_with_paths` paths; float leaves float32, step and
counts int32). Restore is bitwise, and with the step's draws keyed by
(seed, step) (`train.step.TorchDraws`) N steps, save, restore, M steps
equals N + M steps.

`save` writes into a sibling directory whose name is not a number and then
renames it into place (`os.replace`), so `latest_step` never sees a half
written checkpoint; with `max_to_keep` it then deletes the oldest beyond
the newest N. `AsyncSaver` moves the write off the train thread.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from dvdgan_tpu_torch import interop
from dvdgan_tpu_torch.core.tree import tree_map

STATE_FILE = "train_state.npz"


def _write(ckpt_dir: str, step: int, flat: dict[str, np.ndarray],
           max_to_keep: Optional[int]) -> None:
    base = os.path.abspath(ckpt_dir)
    os.makedirs(base, exist_ok=True)
    final = os.path.join(base, str(step))
    tmp = os.path.join(base, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, STATE_FILE), **flat)
    if os.path.exists(final):           # a re-save of the step replaces it
        old = os.path.join(base, f".old-{step}-{os.getpid()}")
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, final)
    if max_to_keep is not None and max_to_keep > 0:
        _prune(base, max_to_keep)


def save(ckpt_dir: str, step: int, state: dict,
         max_to_keep: Optional[int] = None) -> None:
    """Write the train state under ckpt_dir/<step>/ (on the caller's
    thread; a state on the card is copied to the host leaf by leaf)."""
    _write(ckpt_dir, step, interop.train_state_to_flat(state), max_to_keep)


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit()
                  and os.path.isdir(os.path.join(ckpt_dir, d)))


def _prune(ckpt_dir: str, max_to_keep: int) -> None:
    for s in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(s)), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, template: dict) -> dict:
    """The train state saved at `step`, each leaf on the device of the
    template's. Raises FileNotFoundError for a missing step, and ValueError
    when the saved paths, shapes or dtypes differ from the template's."""
    path = os.path.join(os.path.abspath(ckpt_dir), str(step), STATE_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at step {step}: {path}")
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    want = interop.train_state_paths(template)
    if flat.keys() != want.keys():
        missing = sorted(want.keys() - flat.keys())[:5]
        extra = sorted(flat.keys() - want.keys())[:5]
        raise ValueError(f"checkpoint {path} does not match the model: "
                         f"missing {missing}, unexpected {extra}")
    for k, v in want.items():
        dt = np.dtype(np.float32 if v.is_floating_point() else np.int32)
        if flat[k].shape != tuple(v.shape) or flat[k].dtype != dt:
            raise ValueError(f"checkpoint {path}: {k} is {flat[k].dtype}"
                             f"{list(flat[k].shape)}, the model's "
                             f"{dt}{list(v.shape)}")
    return tree_map(lambda new, t: new.to(t.device),
                    interop.load_train_state(flat), template)


def restore_latest(ckpt_dir: str, template: dict
                   ) -> tuple[Optional[int], dict]:
    """(step, state) of the newest checkpoint, or (None, template)."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, template
    return step, restore(ckpt_dir, step, template)


class AsyncSaver:
    """Checkpoints written off the train thread.

    `save()` snapshots the state on the caller's thread: every leaf is
    copied into a pinned host buffer with `non_blocking=True`, one CUDA
    event is recorded after the copies and synchronized, so the snapshot is
    whole before the train thread moves on (the next step builds a new
    state, and the buffers must hold this one). The buffers are kept and
    reused by the next save, since at most one write is in flight. The
    write and the prune then run on a daemon thread. A second `save()` or
    a `wait()` joins the write in flight first and re-raises its failure: a
    checkpoint lost in silence would void the auto-resume contract.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._bufs: dict[str, torch.Tensor] = {}

    def _snapshot(self, state: dict) -> dict[str, np.ndarray]:
        leaves = interop.train_state_paths(state)
        on_card = any(v.is_cuda for v in leaves.values())
        if ({k: (b.shape, b.dtype) for k, b in self._bufs.items()}
                != {k: (v.shape, interop.flat_dtype(v))
                    for k, v in leaves.items()}):
            self._bufs = {k: torch.empty(v.shape, dtype=interop.flat_dtype(v),
                                         pin_memory=on_card)
                          for k, v in leaves.items()}
        for k, v in leaves.items():
            self._bufs[k].copy_(v.detach(), non_blocking=on_card)
        if on_card:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        return {k: b.numpy() for k, b in self._bufs.items()}

    def save(self, ckpt_dir: str, step: int, state: dict,
             max_to_keep: Optional[int] = None) -> None:
        self.wait()
        flat = self._snapshot(state)

        def write():
            try:
                _write(ckpt_dir, step, flat, max_to_keep)
            except Exception as e:   # re-raised on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True,
                                        name=f"ckpt-save-{step}")
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight, if any; re-raise its failure. The slot
        is cleared only after the join returns, so an interrupt during the
        join leaves the write tracked."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err
