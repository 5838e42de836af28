"""The trainer — the counterpart of `dvdgan_tpu/train/trainer.py`.

`Trainer(cfg).train()` builds the train state from `--seed` (or from the
`--weights` npz), auto-resumes from the newest checkpoint under
`out_dir/checkpoints` (or from `--pretrained_model <step>`), and runs the
alternating G/D step (`train.step.train_step`) on the reference's schedule:

  * every `log_step` steps, the scalars of the interval that ended
    `log_step` steps earlier go to `out_dir/logs/scalars.jsonl` (and
    TensorBoard where it imports) with `steps_per_sec` over that interval,
    and one line to stdout with the host ms a step spent waiting for the
    next batch over the interval (`loader_wait_ms`), under K > 1 the kernel
    nodes a step of the K-step graph (`kernels_per_step`), and the step's
    kernel launches (K1 … K6b, counted around the train step alone); the
    last interval is written when the loop ends;
  * every `sample_step` steps, EMA-G samples of a fixed z and y (and for
    DVD-GAN-FP a fixed real prefix, `cond_fixed`: the first cond_frames
    frames of dataset items 0 … n_show − 1) go to
    `out_dir/samples/<step>_grid.png` and `<step>_sample<i>.gif`, and with
    `--log_sigmas` the σ of every SN kernel and every attention γ to the
    scalars;
  * every `eval_step` steps, `evaluate()`: FVD and IS (I3D, from
    `--i3d_weights` or a seeded random init) of `eval_samples` EMA-G
    clips against the dataset's first clips, whose features are computed
    once a run; the scalars go to the log and one `eval @ <step>:` line to
    stdout. It reads only the state and draws from its own generator
    (`eval.evaluate_generator`), so the run's bits are those of the run
    without it;
  * every `model_save_step` steps, a checkpoint (`train.checkpoint`),
    written on a background thread with `--async_save` (the default).

The loop reads no device tensor between log steps. The next batch is
pinned and copied to the card on a side stream by a daemon thread while the
current step runs (`_place`), then cast to the compute dtype there; the
train stream waits for the side stream, and the batch is marked as used on
the train stream so the allocator does not hand its memory back early. A
step's metrics go into pinned host memory with `non_blocking=True` beside a
CUDA event (`_Record`), and a log step waits only on the event of the step
it reports, recorded `log_step` steps earlier: the host stays up to
`log_step` steps ahead of the card. The step's draws are keyed by (seed,
step) from the host's step counter (`train.step.TorchDraws`), so a resumed
run replays the uninterrupted one: same batches (the loader's position is
a function of the step), same draws, bitwise equal state.

With `--steps_per_call K` (K > 1) a loop iteration takes K steps in one
call of `train.step.MultiStep`: on the card one replay of a CUDA graph of
the K steps, captured before the loop submits its first prefetch job; on
the CPU the same K steps eagerly. The prefetch thread places the K
batches stacked; the logged record is the call's last step (the
reference's `_metrics_host` reports the interval's final step); log,
sample and save keep their cadence, which the schedule rule
(`effective_steps_per_call`, the reference's) puts on call boundaries,
and read the state buffers the graph writes; an evaluation runs eagerly
after the call's replay, with no capture open. The launches logged per
step, and under several ranks the collectives (`comm_*`), are counted
during the capture and divided by K (`MultiStep.launches`, `.comms`): a
replay moves no host counter.

`--profile` traces steps 10 to 15 with torch.profiler into
`out_dir/trace` (the window aligned to K; `utils/profiling.py`), with
spans on from before the K-step graph's capture, so that the graph holds
the span markers and their list is written beside the trace
(`steps_<a>_<b>.marks.json`, `MultiStep.marks`): the trace's device time
splits by phase of the step. The loop's own spans are "train.wait" (the
wait for the prefetched batch, counted in
`profiling.COUNTERS.loader_wait_s`, whose change over a log interval the
log line prints), "train.place" (on the prefetch
thread), "train.call" (the batch handed over, the draws' fill, the step
or the replay), "train.record" and "train.report";
`--nan_check` turns on autograd's anomaly mode and checks every step's
metrics, which reads the device each step (asked for); under K > 1 the
graph cannot hold anomaly mode, so each call's stacked metrics are checked
after the call.

Several ranks (`Trainer(cfg, par)`, `par` from `parallel/mesh.py`; the CLI
starts the processes): every rank computes everything, and the leader
(rank 0, `is_main`) alone writes: scalars (the others get a `NullWriter`),
stdout step lines, sample files and checkpoints. The leader's answer to
"which step to resume" is broadcast, so every rank restores the same
checkpoint, and `replicate_state` then gives every rank rank 0's bits.
Each rank's loader decodes only its data index's rows of the global batch
(`local_batch_rows`; time ranks share their rows), and its draws fold in
its data index (`parallel.mesh.rank_shard`). The step is
`make_parallel_train_step`. At the end every rank prints its state digest
and its kernel launches over the run, so that each rank's are read.
Checkpoints are written synchronously by the leader while the others wait
at a barrier (`AsyncSaver` is single-process only, as the reference's
async save is). Sampling and `evaluate()` run on every rank and write on
the leader. The prefetch thread places batches only: every collective is
issued from the train thread. Under `--steps_per_call K` on the card
(NCCL, one card a rank) every rank captures its graph, collectives
inside, at the same point: before its prefetch thread starts.
"""

from __future__ import annotations

import json
import math
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from dvdgan_tpu_torch import interop, kernels
from dvdgan_tpu_torch.core import tree as tru
from dvdgan_tpu_torch.data import (FrameFolderDataset, Loader,
                                   SyntheticVideoDataset)
from dvdgan_tpu_torch.eval import (I3DClassifierProbs, I3DFeatures,
                                   compute_real_features, evaluate_generator)
from dvdgan_tpu_torch.ops import spectral_norm as sn
from dvdgan_tpu_torch.parallel import collectives
from dvdgan_tpu_torch.parallel import mesh as pmesh
from dvdgan_tpu_torch.train import checkpoint as ckpt
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train import step as step_mod
from dvdgan_tpu_torch.utils.config import Config
from dvdgan_tpu_torch.utils import profiling
from dvdgan_tpu_torch.utils.profiling import COUNTERS, span
from dvdgan_tpu_torch.utils.logging import MetricWriter, NullWriter, step_line
from dvdgan_tpu_torch.utils.media import save_batch_gifs, save_video_grid_png


def resolve_device(name: str) -> torch.device:
    """The torch device `name` names; a CUDA device must exist."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           f"(pass --device cpu to run on the CPU)")
    return device


def launch_counts() -> dict[str, int]:
    """Every kernel's launch counter (host integers)."""
    return {"k1": kernels.gru_sequence_fused.launches,
            "k2": kernels.convgru_bwd.gru_sequence_bwd.launches,
            "k3": kernels.gru_sequence_blocked.launches,
            "k5a": kernels.ups2x_fused.ups2x.launches,
            "k5b": kernels.ups2x_fused.ups2x_bwd.launches,
            "k6a": kernels.spatial_attn_fused.launches,
            "k6b": kernels.spatial_attn_tiled.launches}


def effective_steps_per_call(cfg: Config, start_step: int) -> int:
    """The reference's `_effective_steps_per_call`: steps_per_call K when
    every cadence (total, log, sample, save and eval steps, the resume
    step) lands on a call boundary; else 1, with the reference's message
    (chunking would shift the schedule)."""
    k = max(1, cfg.steps_per_call)
    if k == 1:
        return 1
    cadences = [cfg.total_step, cfg.log_step, cfg.sample_step,
                cfg.model_save_step, cfg.eval_step, start_step]
    bad = [c for c in cadences if c and c % k]
    if bad:
        print(f"steps_per_call={k} does not divide schedule points "
              f"{bad}; falling back to per-step dispatch")
        return 1
    return k


def build_dataset(cfg: Config):
    """The reference's `_build_dataset`: synthetic clips, or the frame
    folders under `--data_path`, whose class count must be `--n_classes`."""
    if cfg.dataset == "synthetic":
        return SyntheticVideoDataset(
            n_items=max(cfg.batch_size * 8, 64), n_frames=cfg.n_frames,
            img_size=cfg.img_size, n_classes=cfg.n_classes, seed=cfg.seed)
    if cfg.dataset == "frames":
        ds = FrameFolderDataset(cfg.data_path, cfg.n_frames, cfg.img_size,
                                seed=cfg.seed, npy_range=cfg.npy_range)
        if ds.n_classes != cfg.n_classes:
            raise ValueError(
                f"--n_classes {cfg.n_classes} != {ds.n_classes} classes "
                f"found under {cfg.data_path}")
        return ds
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def dataset_prefixes(ds, cond_frames: int, n: int) -> torch.Tensor:
    """DVD-GAN-FP's real prefixes (n, cond_frames, H, W, 3), float32 on the
    CPU: row i is the first cond_frames frames of item i mod len(ds), as
    the reference's trainer (`cond_fixed`) and main.py take them."""
    return torch.from_numpy(np.stack(
        [ds[i % len(ds)][0][:cond_frames] for i in range(n)]))


class _DaemonPrefetcher:
    """One job at a time on a persistent daemon thread: `submit(fn)`, then
    `result()` (fn's value, or its exception raised here). A daemon thread
    cannot hold up the interpreter's exit, whatever a job is doing."""

    def __init__(self):
        self._in: queue.Queue = queue.Queue(1)
        self._out: queue.Queue = queue.Queue(1)
        self._closed = False
        self._th = threading.Thread(target=self._run, daemon=True,
                                    name="h2d-prefetch")
        self._th.start()

    def _run(self):
        while True:
            fn = self._in.get()
            if fn is None or self._closed:
                return
            try:
                self._out.put((True, fn()))
            except Exception as e:          # raised again by result()
                self._out.put((False, e))
            if self._closed:
                return

    def submit(self, fn) -> "_DaemonPrefetcher":
        self._in.put(fn)
        return self

    def result(self):
        ok, v = self._out.get()
        if ok:
            return v
        raise v

    def shutdown(self) -> None:
        """Asks the thread to end; never blocks."""
        self._closed = True
        try:
            self._in.put_nowait(None)
        except queue.Full:
            pass


class _Mark:
    """A point in the train stream: a timing CUDA event on the card, the
    host clock on the CPU (where every op has ended when it returns)."""

    def __init__(self, step: int, device: torch.device):
        self.step = step
        self.event: Optional[torch.cuda.Event] = None
        self.t = 0.0
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.t = time.perf_counter()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def seconds_since(self, earlier: "_Mark") -> float:
        """Stream time from `earlier` to this mark (both waited for)."""
        if self.event is not None:
            return earlier.event.elapsed_time(self.event) / 1e3
        return self.t - earlier.t


class _Record(_Mark):
    """A step's metrics copied to pinned host memory without waiting for
    the card, its kernel launches and its collectives (host integers);
    at a log step also the host seconds waited for batches over the
    interval it ends (`wait_s`) and the graph's kernel nodes a step."""

    def __init__(self, step: int, metrics: dict, launches: dict,
                 device: torch.device, comms: Optional[dict] = None,
                 kernel_nodes: Optional[float] = None):
        self.names = list(metrics)
        self.launches = launches
        self.comms = comms or {}
        self.kernel_nodes = kernel_nodes
        self.wait_s = 0.0
        values = torch.stack([metrics[k].detach().float()
                              for k in self.names])
        if device.type == "cuda":
            self.host = torch.empty(values.shape, dtype=torch.float32,
                                    pin_memory=True)
            self.host.copy_(values, non_blocking=True)
        else:
            self.host = values
        super().__init__(step, device)

    def metrics(self) -> dict[str, float]:
        self.wait()
        return dict(zip(self.names, self.host.tolist()))


class Trainer:
    def __init__(self, cfg: Config, par: Optional[pmesh.Parallel] = None):
        if par is None and (cfg.multihost or cfg.time_shards > 1
                            or cfg.n_devices > 1):
            raise ValueError("--multihost, --time_shards and --n_devices > 1 "
                             "need one process a rank: `python -m "
                             "dvdgan_tpu_torch --mode train` starts them")
        self.cfg = cfg
        self.par = par
        self.is_main = par is None or par.is_main
        self.device = par.device if par else resolve_device(cfg.device)
        self.g_cfg, self.ds_cfg = cfg.g_config(), cfg.ds_config()
        self.dt_cfg, self.tc = cfg.dt_config(), cfg.train_config()
        self.dtype = torch.bfloat16 if cfg.bf16 else torch.float32

        self.out_dir = cfg.out_dir
        self.ckpt_dir = os.path.join(self.out_dir, "checkpoints")
        self.sample_dir = os.path.join(self.out_dir, "samples")
        if self.is_main:
            os.makedirs(self.out_dir, exist_ok=True)
            self.writer = MetricWriter(os.path.join(self.out_dir, "logs"))
        else:
            self.writer = NullWriter()
        self.saver = (ckpt.AsyncSaver() if cfg.async_save and par is None
                      else None)
        if cfg.async_save and par is not None and self.is_main:
            print("async_save: a multi-process run checkpoints synchronously "
                  "(the leader writes, the others wait)", flush=True)

        state = (interop.load_train_state_npz(cfg.weights) if cfg.weights
                 else train_state.create(cfg.seed, self.g_cfg, self.ds_cfg,
                                         self.dt_cfg))
        self.start_step = int(state["step"])        # on the host still
        resume = cfg.pretrained_model
        if resume is None and self.is_main:
            resume = ckpt.latest_step(self.ckpt_dir)
        if par is not None:     # every rank restores the leader's step
            resume = par.broadcast_int(resume)
        if resume is not None:
            state = ckpt.restore(self.ckpt_dir, resume, state)
            self.start_step = int(resume)
            if self.is_main:
                print(f"resumed from checkpoint step {resume}", flush=True)
        self.state = train_state.to_device(state, self.device)
        self.steps_per_call = effective_steps_per_call(cfg, self.start_step)
        self._multi: Optional[step_mod.MultiStep] = None

        # this rank's rows of the global batch, its draws' fold, its step
        self.rows: Optional[tuple[int, int]] = None
        self.batch = cfg.batch_size
        self.shard: Optional[int] = None
        if par is not None:
            self.state = pmesh.replicate_state(self.state, par)
            if par.n_data > 1:
                self.rows = pmesh.local_batch_rows(par.mesh, cfg.batch_size,
                                                   [par.rank])
                self.batch = self.rows[1] - self.rows[0]
            self.shard = pmesh.rank_shard(par)
        self.groups = pmesh.step_groups(par)
        self.step_fn = pmesh.make_parallel_train_step(
            self.g_cfg, self.ds_cfg, self.dt_cfg, self.tc, par)

        self.dataset = build_dataset(cfg)
        self.loader = Loader(self.dataset, cfg.batch_size, seed=cfg.seed,
                             rows=self.rows, num_threads=cfg.loader_threads,
                             prefetch=cfg.prefetch)
        # fixed latents and labels, so that the dumps compare over training
        gen = torch.Generator().manual_seed(cfg.seed + 1)
        n_show = min(4, cfg.batch_size)
        self.z_fixed = torch.randn(n_show, self.g_cfg.z_dim,
                                   generator=gen).to(self.device, self.dtype)
        self.y_fixed = torch.randint(0, cfg.n_classes, (n_show,),
                                     generator=gen).to(self.device)
        # FP: a fixed real prefix from the dataset conditions the dumps
        self.cond_fixed: Optional[torch.Tensor] = None
        if self.g_cfg.cond_frames > 0:
            self.cond_fixed = dataset_prefixes(
                self.dataset, self.g_cfg.cond_frames, n_show).to(
                self.device, self.dtype)
        self.side = (torch.cuda.Stream(self.device)
                     if self.device.type == "cuda" else None)
        # evaluate(): the default extractor and IS classifier, built at the
        # first call, and the real side's features per (extractor, n)
        self._eval_fx = self._eval_clf = None
        self._real_feats: dict = {}

    # ------------------------------------------------------------------ data
    def _next(self, data) -> tuple:
        """The next batch of the loader; K of them stacked (K, B, …) under
        steps_per_call K > 1."""
        k = self.steps_per_call
        if k == 1:
            return next(data)
        batches = [next(data) for _ in range(k)]
        return tuple(np.stack(parts) for parts in zip(*batches))

    def _place(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Runs on the prefetch thread: the batch on the device in the
        compute dtype, copied on the side stream from pinned memory."""
        with span("train.place"):
            clips, labels = (torch.from_numpy(a) for a in batch)
            if self.side is None:
                return clips.to(self.dtype), labels.long()
            clips, labels = clips.pin_memory(), labels.pin_memory()
            with torch.cuda.stream(self.side):
                real = clips.to(self.device, non_blocking=True).to(self.dtype)
                y = labels.to(self.device, non_blocking=True).long()
            return real, y

    def _multi_step(self) -> step_mod.MultiStep:
        """The K-step call, built at the first K-step loop. On the card its
        graph is captured here, before the loop submits its first prefetch
        job: under the default (global) capture mode a CUDA call from
        another thread (the prefetch thread's pin_memory, its side-stream
        copy) would break the capture. The loader's threads do no CUDA
        call, nor does the checkpoint writer (its snapshot is taken and
        waited for on this thread)."""
        if self._multi is None:
            c = self.cfg
            self._multi = step_mod.MultiStep(
                self.state, self.steps_per_call, self.batch, self.g_cfg,
                self.ds_cfg, self.dt_cfg, self.tc, c.seed, self.dtype,
                self.device, launch_counts, shard=self.shard, **self.groups)
            self.state = self._multi.state
            if self.device.type == "cuda":
                self._multi.capture()
                print(f"captured {self.steps_per_call} train steps into one "
                      f"CUDA graph in {self._multi.capture_s:.1f} s",
                      flush=True)
        return self._multi

    def _take(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """A placed batch, ready on the train stream."""
        if self.side is not None:
            train = torch.cuda.current_stream(self.device)
            train.wait_stream(self.side)
            for t in batch:
                t.record_stream(train)
        return batch

    # ----------------------------------------------------------------- train
    def train(self, total_step: Optional[int] = None) -> dict[str, float]:
        """Steps from `start_step` up to `total_step` (default
        cfg.total_step); -> the last step's metrics."""
        c = self.cfg
        total = c.total_step if total_step is None else total_step
        k = self.steps_per_call
        if k > 1 and total % k:
            raise ValueError(f"total_step override {total} is not a "
                             f"multiple of steps_per_call {k}")
        spans_were = profiling.enabled()
        if c.profile:       # before the capture: the graph holds the marks
            profiling.enable(True)
        multi = self._multi_step() if k > 1 else None
        bpe = max(self.loader.batches_per_epoch(), 1)
        data = self.loader.forever(self.start_step // bpe,
                                   self.start_step % bpe)
        prefetch = _DaemonPrefetcher()
        pending = None
        lagged: Optional[_Record] = None    # the last log step's record
        since = _Mark(self.start_step, self.device)
        metrics: dict[str, torch.Tensor] = {}
        first = self.start_step
        launched = dict.fromkeys(launch_counts(), 0)    # over the run
        wait_at = COUNTERS.loader_wait_s    # the loader's wait at the last log
        prof = None
        prof_start = self.start_step + k * max(1, 10 // k)
        prof_stop = prof_start + k * max(1, 5 // k)
        with profiling.anomaly_mode(c.nan_check and k == 1):
            try:
                for i in range(self.start_step, total, k):
                    if c.profile and i == prof_start:
                        prof = profiling.start_trace(self.device)
                    if prof is not None and i == prof_stop:
                        path = os.path.join(self.out_dir, "trace",
                                            f"steps_{prof_start}_{i}")
                        profiling.stop_trace(prof, path + ".json",
                                             self.device)
                        if multi is not None:
                            with open(path + ".marks.json", "w") as f:
                                json.dump(multi.marks, f)
                        prof = None
                    if pending is not None:
                        t0 = time.perf_counter()
                        with span("train.wait"):
                            batch, pending = pending.result(), None
                        COUNTERS.loader_wait_s += time.perf_counter() - t0
                        COUNTERS.loader_wait_steps += k
                    else:
                        batch = self._place(self._next(data))
                    if i + k < total:       # the next call's batches meanwhile
                        pending = prefetch.submit(
                            lambda: self._place(self._next(data)))
                    with span("train.call"):
                        real, y = self._take(batch)
                        if multi is not None:   # the metrics stacked (K,)
                            self.state, out = multi(self.state, real, y, i)
                            launches, comms = multi.launches, multi.comms
                            metrics = {name: v[-1] for name, v in out.items()}
                        else:
                            comms_at = collectives.COUNTS.snapshot()
                            draws = step_mod.TorchDraws(
                                c.seed, i, self.batch, self.g_cfg.z_dim,
                                self.g_cfg.n_frames, self.ds_cfg.k_frames,
                                self.dtype, self.device, shard=self.shard)
                            before = launch_counts()
                            self.state, out = self.step_fn(self.state, real,
                                                           y, draws)
                            launches = {name: n - before[name] for name, n
                                        in launch_counts().items()}
                            comms = {name: v - comms_at[name] for name, v
                                     in collectives.COUNTS.snapshot().items()}
                            metrics = out
                    step = i + k
                    for name, n in launches.items():
                        launched[name] += n * k
                    if c.nan_check:
                        _check_finite(out, step)
                    with span("train.record"):
                        record = _Record(
                            step, metrics, launches, self.device,
                            comms if self.par is not None else None,
                            multi.kernel_nodes if multi is not None else None)
                    if step % c.log_step == 0:
                        record.wait_s = COUNTERS.loader_wait_s - wait_at
                        wait_at = COUNTERS.loader_wait_s
                        if lagged is not None:
                            since = self._report(lagged, since)
                        lagged = record
                    if c.sample_step and step % c.sample_step == 0:
                        self.dump_samples(step)
                        if c.log_sigmas:
                            self.writer.scalars(self.sn_diagnostics(), step)
                    if c.eval_step and step % c.eval_step == 0:
                        ev = self.evaluate()
                        self.writer.scalars(ev, step)
                        if self.is_main:
                            print(f"eval @ {step}: " + " ".join(
                                f"{k} {v:.4f}" for k, v in ev.items()),
                                flush=True)
                    if c.model_save_step and step % c.model_save_step == 0:
                        self.save(step)
            except BaseException:
                self._flush_saver(unwinding=True)
                raise
            finally:
                if pending is not None:     # let the thread leave `data` first
                    try:
                        pending.result()
                    except Exception:
                        pass
                prefetch.shutdown()
                data.close()
                if prof is not None:
                    prof.stop()
                profiling.enable(spans_were)
        self._flush_saver()
        if lagged is not None:          # the last interval, not yet written
            self._report(lagged, since)
        self.start_step = max(self.start_step, total)
        if self.par is not None:    # the replicas, compared by digest
            digest, n = interop.state_digest(self.state)
            print(f"rank {self.par.rank}: state digest {digest} over {n} "
                  f"leaves", flush=True)
            print(f"rank {self.par.rank}: launches {json.dumps(launched)} "
                  f"over {max(0, total - first)} steps", flush=True)
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.device) / 2**30
            print(f"peak device memory {peak:.3f} GiB", flush=True)
        return {name: float(v) for name, v in metrics.items()}

    def _report(self, rec: _Record, since: _Mark) -> _Record:
        """Writes `rec` (waiting on its event alone) with the steps/s of
        the interval since `since`; -> rec, the next interval's start."""
        with span("train.report"):
            m = rec.metrics()
            secs = rec.seconds_since(since)
            steps = rec.step - since.step
            sps = steps / secs if secs > 0 else 0.0
            self.writer.scalars(m, rec.step)
            self.writer.scalar("steps_per_sec", sps, rec.step)
            if self.is_main:
                wait_ms = rec.wait_s * 1e3 / max(steps, 1)
                host = [f"loader_wait_ms {wait_ms:.4f}"]
                if rec.kernel_nodes is not None:
                    host.append(f"kernels_per_step {rec.kernel_nodes:g}")
                print(" | ".join([step_line(rec.step, m, sps)] + host
                                 + [f"{k}_launches {n}"
                                    for k, n in rec.launches.items()]
                                 + [f"comm_{k} {n}"
                                    for k, n in rec.comms.items()]),
                      flush=True)
        return rec

    def save(self, step: int) -> None:
        """A checkpoint of the state at `step`: on a thread (`AsyncSaver`)
        or here; with several ranks the leader writes, prunes and renames
        while the others wait at a barrier."""
        keep = self.cfg.keep_checkpoints or None
        if self.saver is not None:
            self.saver.save(self.ckpt_dir, step, self.state, max_to_keep=keep)
        elif self.is_main:
            ckpt.save(self.ckpt_dir, step, self.state, max_to_keep=keep)
        if self.par is not None:
            self.par.barrier()

    def _flush_saver(self, unwinding: bool = False) -> None:
        """Joins the write in flight. On the normal path its failure
        propagates; while unwinding it is printed, so that it does not hide
        the error in flight."""
        if self.saver is None:
            return
        if not unwinding:
            self.saver.wait()
            return
        try:
            self.saver.wait()
        except RuntimeError as e:
            print(f"async checkpoint flush failed during teardown: {e}")

    # ---------------------------------------------------------- diagnostics
    @torch.no_grad()
    def sn_diagnostics(self) -> dict[str, float]:
        """σ of every SN kernel (from the stored u, not advanced) and every
        attention γ, as `sigma/<model>/<path>` and `gamma/<model>/<path>`;
        one read of the device."""
        out = {}
        for m in ("g", "ds", "dt"):
            sig = sn.sn_sigmas(self.state[m]["params"], self.state[m]["sn_u"])
            out.update({f"sigma/{m}/{p}": v for p, v in sig.items()})
            flat = tru.flatten_with_paths(self.state[m]["params"])
            out.update({f"gamma/{m}/{p}": v for p, v in flat.items()
                        if p.rsplit("/", 1)[-1] == "gamma"})
        values = torch.stack([v.float().reshape(()) for v in out.values()])
        return dict(zip(out, values.cpu().tolist()))

    # ------------------------------------------------------------------ eval
    def evaluate(self, extractor=None, n_samples: Optional[int] = None
                 ) -> dict[str, float]:
        """FVD (and IS from the same I3D logits) of EMA-G samples against
        the dataset: the --eval_step evaluation. The default extractor is
        I3D from --i3d_weights (a seeded random init without: trends, not
        published-comparable numbers), built once on the run's device;
        pass another to override (no IS then). The real side is computed
        once per (extractor object, n) and kept."""
        if extractor is None:
            if self._eval_fx is None:
                self._eval_fx = I3DFeatures(self.cfg.i3d_weights or None,
                                            seed=0, device=self.device)
                self._eval_clf = I3DClassifierProbs(
                    feature_extractor=self._eval_fx)
            extractor, clf = self._eval_fx, self._eval_clf
        else:
            clf = None
        n = min(self.cfg.eval_samples if n_samples is None else n_samples,
                len(self.dataset))
        batch = min(self.cfg.batch_size, n)
        key = (extractor, n)    # the object itself: an id() could be reused
        if key not in self._real_feats:
            self._real_feats[key] = compute_real_features(
                self.dataset, extractor, n, batch_size=batch)
        return evaluate_generator(self, extractor, n_samples=n,
                                  batch_size=batch, classifier=clf,
                                  real_features=self._real_feats[key])

    # ---------------------------------------------------------------- sample
    def sample(self, z: Optional[torch.Tensor] = None,
               y: Optional[torch.Tensor] = None,
               cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """EMA-G clips (B, T, H, W, 3) in [-1, 1] of z and y (default: the
        fixed ones): the generated frames only; FP conditions on `cond`
        (default: the first B rows of `cond_fixed`)."""
        st = self.state
        z = self.z_fixed if z is None else z
        y = self.y_fixed if y is None else y
        if cond is None and self.cond_fixed is not None:
            cond = self.cond_fixed[:z.shape[0]]
        return step_mod.sample(st["g_ema"], st["g"]["stats"], st["g"]["sn_u"],
                               z, y, self.g_cfg, cond_video=cond)

    def dump_samples(self, step: int) -> None:
        """EMA-G samples of the fixed z and y, computed on every rank and
        written by the leader."""
        videos = self.sample()
        if not self.is_main:
            return
        videos = videos.float().cpu().numpy()
        save_video_grid_png(
            os.path.join(self.sample_dir, f"{step}_grid.png"), videos)
        save_batch_gifs(self.sample_dir, videos, step)

    def close(self) -> None:
        """Ends the run's writers and loader, and drops the K-step call's
        CUDA graph: under NCCL the process group's destruction waits until
        every graph that captured its collectives is freed."""
        if self.saver is not None:
            self.saver.wait()
        self.writer.close()
        self.loader.close()
        self._multi = None


def _check_finite(metrics: dict[str, torch.Tensor], step: int) -> None:
    """Raises FloatingPointError at a non-finite metric (reads the card);
    a K-step call's metrics are stacked (K,) and `step` is its last."""
    values = {k: v.reshape(-1).tolist() for k, v in metrics.items()}
    bad = {k: v for k, v in values.items()
           if not all(map(math.isfinite, v))}
    if bad:
        raise FloatingPointError(f"non-finite metrics at step {step}: {bad}")
