"""The alternating G/D train step and sampling — the counterpart of
`dvdgan_tpu/train/step.py` (`train_step` and `sample`).

One `train_step` = d_steps discriminator updates + one generator update +
EMA, with the reference's contracts:

  * G's σ-normalization runs once for the whole D phase (`update=False`),
    and ONE G forward at batch d_steps·B makes every D step's fakes
    (`tc.fake_gen="pooled"`: their CBN statistics pool over all d_steps
    batches), or d_steps forwards at batch B, one a D step with its own
    statistics (`"per_step"`), without grad; the BN running-stat write is
    discarded;
  * the real clip and all the fakes are φ-pooled (2× spatial mean) once,
    and DT takes them with `pooled=True`;
  * each D step scores real and fake in ONE shared forward through DS and
    through DT (D has no batch-coupled ops), takes the hinge losses, and
    advances DS's and DT's SN `u` and Adam;
  * the G update goes back through DS and DT (their σ from frozen u); G's
    SN `u` and BN running stats advance only here;
  * EMA of G's params, then step + 1.

DVD-GAN-FP (`g_cfg.cond_frames` = cf > 0): the clip's first cf frames are
G's real prefix and G generates the other n_frames. DS takes its real and
fake frames from the generated part only; DT scores whole clips, the fake
one being the real prefix followed by the generated frames.

Gradient accumulation (`tc.grad_accum` = k > 1, the reference's contract):
the batch splits into k equal micro-batches and each optimizer update takes
the MEAN of the k micro-gradients, one micro-batch's activations alive at a
time. Every draw is made at full batch and sliced, so k never changes the z
or frame-index streams. The D-phase fakes stay ONE full-batch G forward, so
the D updates are the full-batch ones up to float reassociation of the
mean; SN `u` depends on the params only and is taken from the last micro.
The G phase recomputes G per micro-batch, so its CBN normalizes over
micro-batch statistics (the one deviation from k = 1), and G's new running
stats are the mean of the micro updates. Losses are means over the micros.

Randomness goes through one hook, `draws` (an object with `z(stream)` and
`idx(stream)`): stream i in the reference's
key-split order (`dvdgan_tpu/train/step.py:152-178`) is, for D step i,
3i → z, 3i+1 → real frame indices, 3i+2 → fake frame indices, and then
3·d_steps → G's z, 3·d_steps+1 → G's frame indices. Frame indices are per
clip, uniform without replacement. `TorchDraws(seed, step, ...)` draws them
from a torch.Generator on the device seeded by (seed, step), the
counterpart of the reference's `fold_in(key, step)`: the trainer passes the
step number from the host, so the draws of step s are the same whether the
run started at 0 or resumed, and no device read is needed to learn s. A
test feeds the reference's own draws.

With `tc.log_grad_norms` the metrics also hold `d_grad_norm` (the last D
step's mean gradient over DS and DT together) and `g_grad_norm`, each the
f32 global L2 norm of the whole gradient tree.

Gradients are `torch.autograd.grad` of the loss with respect to detached
copies of the f32 master params; the step builds a new state tree and
leaves the old one as it was.

`MultiStep` runs K train steps per call, the counterpart of the
reference's `scan_steps`: on a CUDA device the K steps are ONE CUDA graph,
captured once and replayed once a call; on the CPU the same steps run
eagerly on the same buffers.

Data and time parallelism (`group`, `time_group`: this rank's process
groups from `parallel/mesh.py`; the reference's `axis_name` and
`time_axis`). Each rank holds its data index's rows of the global batch
and draws with `TorchDraws(..., shard=data index)` (`ShardedDraws` replays
an r-rank run's draws in one process, the reference's `rng_shards=r`).
G's forwards normalize with batch moments averaged over `group`
(cross-replica BN). With `time_group`, DT runs time-sharded
(`parallel/time_shard.py`): each time rank takes its T/n window of every
clip DT scores and the per-clip score is summed over the group; G and DS
are replicated along time. The φ pre-pool stays: it is per frame, so the
window of the pooled clip has the bits of the pooled window. After each
update's gradient accumulation the gradients are averaged over `group`
and then over `time_group` (`collectives.mean_tree`, one buffer a model
and group), and so are the metrics. Under time sharding every rank
computes the same loss from the summed score, so a rank's DT cotangent is
n_time times its own partial; the mean over time gives back their sum,
the unsharded gradient (the reference's argument, `step.py:40-48`). G's
new BN running stats are averaged over `time_group` too: the time ranks
compute them from the same inputs, so the mean leaves them as they are
where the ranks agree, and makes them agree where a non-deterministic
kernel made them differ.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from dvdgan_tpu_torch.core import tree as tru
from dvdgan_tpu_torch.models import DSConfig, DTConfig, GConfig
from dvdgan_tpu_torch.models import discriminator, generator
from dvdgan_tpu_torch.ops import losses, resize
from dvdgan_tpu_torch.ops import spectral_norm as sn
from dvdgan_tpu_torch.parallel import collectives, time_shard
from dvdgan_tpu_torch.train import state as train_state
from dvdgan_tpu_torch.train.state import TrainConfig
from dvdgan_tpu_torch.utils import profiling
from dvdgan_tpu_torch.utils.profiling import span


_MASK64 = (1 << 64) - 1
FAKE_GEN = ("pooled", "per_step")


def splitmix64(x: int) -> int:
    """One output of the splitmix64 generator whose state is x."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def step_seed(seed: int, step: int, shard: Optional[int] = None) -> int:
    """The 64-bit seed of step `step`'s draws: splitmix64 of the run's own
    splitmix64(seed) plus the step, so that runs with neighbouring seeds do
    not share streams (as seed + step would). A data rank's draws fold in
    its index `shard` (the reference folds the data-axis index into the
    step's key); None leaves the one-process streams."""
    s = splitmix64((splitmix64(seed) + step) & _MASK64)
    if shard is None:
        return s
    return splitmix64((s + splitmix64(shard + 1)) & _MASK64)


class TorchDraws:
    """The draws of train step `step` from a torch.Generator on `device`
    seeded with `step_seed(seed, step)`: z ∼ N(0, 1) in the compute dtype,
    frame indices as the first k of a per-clip random permutation of T.
    Draws come from the one generator in call order; `stream` only names
    the draw (a replaying hook keys on it). `shard`: the data rank whose
    rows these are (`step_seed`)."""

    def __init__(self, seed: int, step: int, batch: int, z_dim: int,
                 n_frames: int, k: int, dtype: torch.dtype,
                 device: torch.device | str, shard: Optional[int] = None):
        self.gen = torch.Generator(device).manual_seed(
            step_seed(seed, step, shard))
        self.b, self.z_dim = batch, z_dim
        self.t, self.k, self.dtype = n_frames, k, dtype

    def z(self, stream: int) -> torch.Tensor:
        return torch.randn(self.b, self.z_dim, generator=self.gen,
                           device=self.gen.device, dtype=self.dtype)

    def idx(self, stream: int) -> torch.Tensor:
        u = torch.rand(self.b, self.t, generator=self.gen,
                       device=self.gen.device)
        return u.argsort(dim=1)[:, :self.k]


class ShardedDraws:
    """The draws an r-rank data-parallel run makes at step `step`, for one
    process that holds the whole global batch: stream by stream, the r
    ranks' `TorchDraws` (batch/r rows each, shard g for rank g) in rank
    order — the counterpart of the reference's `rng_shards=r`."""

    def __init__(self, r: int, seed: int, step: int, batch: int, z_dim: int,
                 n_frames: int, k: int, dtype: torch.dtype,
                 device: torch.device | str):
        if batch % r:
            raise ValueError(f"batch {batch} not divisible by {r} shards")
        self.parts = [TorchDraws(seed, step, batch // r, z_dim, n_frames, k,
                                 dtype, device, shard=g) for g in range(r)]

    def z(self, stream: int) -> torch.Tensor:
        return torch.cat([d.z(stream) for d in self.parts])

    def idx(self, stream: int) -> torch.Tensor:
        return torch.cat([d.idx(stream) for d in self.parts])


def draw_order(d_steps: int) -> list[tuple[str, int]]:
    """(kind, stream) of every draw `train_step` makes, in its call order:
    the D phase's z (3i for each D step i), then per D step the real and
    the fake frame indices (3i+1, 3i+2), then G's z and frame indices. The
    order is the same under both `fake_gen` modes (`per_step` draws each z
    just before its forward, no other draw in between)."""
    order = [("z", 3 * i) for i in range(d_steps)]
    order += [("idx", 3 * i + j) for i in range(d_steps) for j in (1, 2)]
    return order + [("z", 3 * d_steps), ("idx", 3 * d_steps + 1)]


class HeldDraws:
    """One step's draws held in buffers, by stream: `z(stream)` and
    `idx(stream)` return the buffers. `fill(draws)` writes into them what
    `draws` gives when called in `draw_order`, the order in which
    `train_step` calls it, so a step fed these buffers sees the draws it
    would have made itself."""

    def __init__(self, d_steps: int, batch: int, z_dim: int, k: int,
                 dtype: torch.dtype, device: torch.device):
        self.order = draw_order(d_steps)
        self.zs = {s: torch.zeros(batch, z_dim, dtype=dtype, device=device)
                   for kind, s in self.order if kind == "z"}
        # frame 0 everywhere: valid indices before the first fill
        self.ids = {s: torch.zeros(batch, k, dtype=torch.long, device=device)
                    for kind, s in self.order if kind == "idx"}

    def fill(self, draws) -> None:
        for kind, s in self.order:
            buf = self.zs[s] if kind == "z" else self.ids[s]
            buf.copy_(getattr(draws, kind)(s))

    def z(self, stream: int) -> torch.Tensor:
        return self.zs[stream]

    def idx(self, stream: int) -> torch.Tensor:
        return self.ids[stream]


def take_frames(video: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """video: (B, T, H, W, C), idx: (B, k) -> (B, k, H, W, C)."""
    rows = torch.arange(video.shape[0], device=video.device)[:, None]
    return video[rows, idx]


def _value_and_grad(loss_fn: Callable[[Any], tuple[torch.Tensor, Any]],
                    params: Any) -> tuple[torch.Tensor, Any, Any]:
    """(loss, aux, d loss / d params) with params a tree of tensors; a
    leaf the loss does not reach gets a zero gradient, as under jax.grad."""
    leaves = tru.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, aux = loss_fn(leaves)
    flat = tru.flatten_with_paths(leaves)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), aux, tru.unflatten(dict(zip(flat, grads)))


def _accum_grads(loss_fn: Callable[..., tuple[torch.Tensor, Any]], params: Any,
                 args: tuple, k: int) -> tuple[torch.Tensor, list, Any]:
    """`loss_fn(params, *args)` over k micro-batches (each of `args` sliced
    along its batch axis), one after the other. -> (mean loss, the k aux
    values, mean gradient)."""
    m = args[0].shape[0] // k
    losses_, auxes, acc = [], [], None
    for j in range(k):
        part = tuple(a[j * m:(j + 1) * m] for a in args)
        loss, aux, g = _value_and_grad(lambda p: loss_fn(p, *part), params)
        acc = g if acc is None else tru.tree_map(torch.add, acc, g)
        losses_.append(loss)
        auxes.append(aux)
    if k > 1:
        acc = tru.tree_map(lambda a: a / k, acc)
    return torch.stack(losses_).mean(), auxes, acc


def _global_norm(grads: Any) -> torch.Tensor:
    """The L2 norm over the whole gradient tree, in f32."""
    leaves = tru.flatten_with_paths(grads).values()
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def _adam(grads: Any, model: dict, lr: float, tc: TrainConfig
          ) -> tuple[Any, dict]:
    with span("adam"):
        return train_state.adam_update(grads, model["opt"], model["params"],
                                       lr, tc.beta1, tc.beta2)


def train_step(state: dict, real: torch.Tensor, y: torch.Tensor, draws,
               g_cfg: GConfig, ds_cfg: DSConfig, dt_cfg: DTConfig,
               tc: TrainConfig, group=None, time_group=None
               ) -> tuple[dict, dict[str, torch.Tensor]]:
    """(state, real (B, cond_frames + n_frames, H, W, 3) in [-1, 1] in the
    compute dtype, y (B,) class ids, draws) -> (new state, metrics {d_loss,
    d_loss_s, d_loss_t, g_loss} and with `tc.log_grad_norms` {d_grad_norm,
    g_grad_norm}, as f32 scalars on the device; the D losses and norm are
    the last D step's). `group`, `time_group`: this rank's data and time
    process groups (module docstring); B is then the rank's rows. Its
    phases are the spans (`utils/profiling.py:span`) "step.fakes" (G's
    no-grad pass and the φ-pooling), "step.d" (each D update) and "step.g"
    (G's update, EMA, the metrics' mean)."""
    if tc.fake_gen not in FAKE_GEN:
        raise ValueError(f"fake_gen must be one of {FAKE_GEN}, got "
                         f"{tc.fake_gen!r}")
    b, t = real.shape[:2]
    cf = g_cfg.cond_frames
    if t - cf != g_cfg.n_frames:
        raise ValueError(f"clip length {t} != cond_frames {cf} + n_frames "
                         f"{g_cfg.n_frames}")
    cond = real[:, :cf] if cf else None
    real_gen = real[:, cf:]
    ka = tc.grad_accum
    if b % ka:
        raise ValueError(f"batch {b} not divisible by grad_accum {ka}")
    dtype = real.dtype
    d_steps = tc.d_steps
    if collectives.size(time_group) == 1:
        time_group = None
    grad_groups = (group, time_group)

    def dt_score(dt_sn, clip, yy, pooled=False):
        if time_group is None:
            return discriminator.dt_apply(dt_sn, clip, yy, dt_cfg,
                                          pooled=pooled)
        return time_shard.make_sharded_dt(dt_sn, dt_cfg, time_group,
                                          pooled=pooled)(clip, yy)

    # ---- fakes for every D step, no grad ----------------------------------
    with torch.no_grad(), span("step.fakes"):
        g_sn, _ = sn.sn_normalize(state["g"]["params"], state["g"]["sn_u"],
                                  update=False, compute_dtype=dtype)
        if tc.fake_gen == "pooled":     # one forward at batch d_steps·B
            z_all = torch.cat([draws.z(3 * i) for i in range(d_steps)])
            cond_all = None if cond is None else cond.repeat(
                d_steps, 1, 1, 1, 1)
            fake_all, _ = generator.apply(g_sn, state["g"]["stats"], z_all,
                                          y.repeat(d_steps), g_cfg,
                                          train=True, cond_video=cond_all,
                                          group=group)
        else:       # per_step: a forward at batch B, own batch statistics
            fake_all = torch.cat([
                generator.apply(g_sn, state["g"]["stats"], draws.z(3 * i), y,
                                g_cfg, train=True, cond_video=cond,
                                group=group)[0]
                for i in range(d_steps)])
        real_dt = resize.avg_pool_2x_video(real)
        fake_all_dt = resize.avg_pool_2x_video(fake_all)
        cond_dt = real_dt[:, :cf]

    # ---- D phase × d_steps ------------------------------------------------
    ds, dt = state["ds"], state["dt"]
    metrics: dict[str, torch.Tensor] = {}
    for i in range(d_steps):
        with span("step.d"):
            real_frames = take_frames(real_gen, draws.idx(3 * i + 1))
            fake_frames = take_frames(fake_all[i * b:(i + 1) * b],
                                      draws.idx(3 * i + 2))
            fake_dt = fake_all_dt[i * b:(i + 1) * b]
            if cf:      # the fake clip DT scores: the real prefix, then G's
                fake_dt = torch.cat([cond_dt, fake_dt], dim=1)

            # called right away, so the models it reads are this D step's
            def d_loss_fn(d_params, rf, ff, rh, fh, yj):
                ds_sn, ds_u = sn.sn_normalize(d_params["ds"], ds["sn_u"],
                                              update=True, compute_dtype=dtype)
                dt_sn, dt_u = sn.sn_normalize(d_params["dt"], dt["sn_u"],
                                              update=True, compute_dtype=dtype)
                n = rf.shape[0]
                yy = torch.cat([yj, yj])
                ds_both = discriminator.ds_apply(
                    ds_sn, torch.cat([rf, ff]), yy, ds_cfg)
                dt_both = dt_score(dt_sn, torch.cat([rh, fh]), yy, pooled=True)
                l_ds = losses.d_hinge(ds_both[:n], ds_both[n:])
                l_dt = losses.d_hinge(dt_both[:n], dt_both[n:])
                return l_ds + l_dt, (l_ds.detach(), l_dt.detach(), ds_u, dt_u)

            d_loss, auxes, grads = _accum_grads(
                d_loss_fn, {"ds": ds["params"], "dt": dt["params"]},
                (real_frames, fake_frames, real_dt, fake_dt, y), ka)
            l_ds = torch.stack([a[0] for a in auxes]).mean()
            l_dt = torch.stack([a[1] for a in auxes]).mean()
            ds_u, dt_u = auxes[-1][2:]
            grads = collectives.mean_tree(grads, grad_groups)
            ds_params, ds_opt = _adam(grads["ds"], ds, tc.lr_d, tc)
            dt_params, dt_opt = _adam(grads["dt"], dt, tc.lr_d, tc)
            ds = {"params": ds_params, "sn_u": ds_u, "opt": ds_opt}
            dt = {"params": dt_params, "sn_u": dt_u, "opt": dt_opt}
            metrics.update(d_loss=d_loss, d_loss_s=l_ds, d_loss_t=l_dt)
            if tc.log_grad_norms and i == d_steps - 1:
                metrics["d_grad_norm"] = _global_norm(grads)

    # ---- G phase × 1 ------------------------------------------------------
    with span("step.g"):
        z_g = draws.z(3 * d_steps)
        idx_g = draws.idx(3 * d_steps + 1)
        with torch.no_grad():
            ds_sn, _ = sn.sn_normalize(ds["params"], ds["sn_u"], update=False,
                                       compute_dtype=dtype)
            dt_sn, _ = sn.sn_normalize(dt["params"], dt["sn_u"], update=False,
                                       compute_dtype=dtype)
        g = state["g"]

        def g_loss_fn(g_params, z_j, idx_j, y_j, cond_j=None):
            g_sn, g_u = sn.sn_normalize(g_params, g["sn_u"], update=True,
                                        compute_dtype=dtype)
            fake, g_stats = generator.apply(g_sn, g["stats"], z_j, y_j, g_cfg,
                                            train=True, cond_video=cond_j,
                                            group=group)
            s_ds = discriminator.ds_apply(ds_sn, take_frames(fake, idx_j), y_j,
                                          ds_cfg)
            dt_in = (fake if cond_j is None
                     else torch.cat([cond_j, fake], dim=1))
            s_dt = dt_score(dt_sn, dt_in, y_j)
            g_loss = losses.g_hinge(s_ds) + losses.g_hinge(s_dt)
            return g_loss, (g_u, tru.tree_map(torch.Tensor.detach, g_stats))

        fields = (z_g, idx_g, y) + ((cond,) if cf else ())
        g_loss, auxes, g_grads = _accum_grads(g_loss_fn, g["params"],
                                              fields, ka)
        g_u = auxes[-1][0]
        # the running-stat update is linear in the batch moments: the mean over
        # the micros is one update with the mean micro-moment
        g_stats = auxes[0][1] if ka == 1 else tru.tree_map(
            lambda *s: torch.stack(s).mean(0), *(a[1] for a in auxes))
        g_grads = collectives.mean_tree(g_grads, grad_groups)
        g_stats = collectives.mean_tree(g_stats, (time_group,))
        g_params, g_opt = _adam(g_grads, g, tc.lr_g, tc)
        step = state["step"]
        with span("ema"):
            g_ema = train_state.ema_update(state["g_ema"], g_params,
                                           tc.ema_decay, step, tc.ema_start)
        new_state = {
            "step": step + 1,
            "g": {"params": g_params, "stats": g_stats, "sn_u": g_u,
                  "opt": g_opt},
            "ds": ds,
            "dt": dt,
            "g_ema": g_ema,
        }
        metrics["g_loss"] = g_loss
        if tc.log_grad_norms:
            metrics["g_grad_norm"] = _global_norm(g_grads)
        metrics = collectives.mean_tree(metrics, grad_groups)
    return new_state, metrics


def _copy_tree(dst: Any, src: Any) -> None:
    """Every leaf of `src` into the leaf of `dst` at the same path."""
    d, s = tru.flatten_with_paths(dst), tru.flatten_with_paths(src)
    if d.keys() != s.keys():
        raise ValueError(f"state trees differ: {sorted(d.keys() ^ s.keys())}")
    torch._foreach_copy_(list(d.values()), [s[p] for p in d])


def capture_mode() -> str:
    """The CUDA-graph capture mode of `MultiStep`: the default global mode,
    which fails the capture when another thread makes an unsafe CUDA call,
    except in a process with an NCCL process group. Its watchdog thread
    polls the CUDA events of the collectives in flight, outside any
    capture; "thread_local" confines the capture's restrictions to the
    capturing thread, so that such a poll cannot break it. The trainer's
    own threads stay idle during a capture under either mode."""
    nccl = dist.is_available() and dist.is_initialized() and (
        dist.get_backend() == "nccl")
    return "thread_local" if nccl else "global"


class MultiStep:
    """K train steps per call — the counterpart of the reference's
    `scan_steps` (`dvdgan_tpu/train/step.py`). Step j of a call takes
    batch j of `reals` (K, B, T, H, W, 3) and `ys` (K, B) and the draws of
    step `start + j` (`TorchDraws(seed, start + j, …)`), so a call leaves
    the state of K single steps; the metrics come back stacked along a
    leading K axis.

    The object owns static buffers: the train state (a copy of the one it
    is built from; `self.state`, which a call returns), the K batches and
    the K steps' draws (`HeldDraws`). A call copies a state that is not
    its own into the buffers, copies the batches in, fills the draws
    outside the steps, and then:

      * on a CUDA device, replays ONE CUDA graph of the K steps: step j's
        output state feeds step j + 1 inside the graph, and the last one
        is copied back into the state buffers, so the next replay goes on
        from it. The graph is captured at the first call (or by
        `capture()`), after one eager warm-up step on a side stream from
        the same buffers whose outputs are dropped (the step writes
        nothing in place, so the state is as it was). A capture that fails
        raises: on the card there is no eager fallback;
      * on the CPU, runs the same K steps eagerly on the same buffers.

    The graph cannot hold autograd's anomaly mode: capturing under it
    raises. `launches` is each kernel's launches per step (`counts()`
    before and after, divided by K) and `comms` the collectives and bytes
    per step (`collectives.COUNTS` the same way): around the capture on
    the card, where a replay moves no host counter, and around each call
    on the CPU. `nodes` counts the captured graph's nodes by type
    (`profiling.graph_nodes`), and `kernel_nodes` is its kernel nodes, less
    the span markers, over K (also `profiling.COUNTERS.kernel_nodes`). With
    spans on
    (`profiling.enable`) the capture takes in a marker kernel where each
    span of the steps begins and ends (the phases of `train_step`, `sn`,
    `adam`, `ema`, G's levels), and `marks` lists what the
    markers of one replay stand for, in order: (span, "B" | "E"). A graph
    captured with spans off holds no marker, and spans switched on later
    reach it only through a new capture.

    Under data or time parallelism (`group`, `time_group` of more than one
    rank; the draws folded by `shard`, as `train_step` takes them) the CPU
    runs the K steps eagerly as ever. On a CUDA device the groups must be
    NCCL's (one card a rank): the graph then holds the steps' collectives
    (BN's all-reduces, the gradient and metric means, DT's halo
    all-gathers and score sums) on NCCL's stream, and a replay issues them
    on every rank in the order of the capture. The warm-up step issues the
    same collectives, so every group's communicator exists before the
    capture and the ranks' calls stay matched. Gloo's collectives run on
    the host, which a graph cannot hold: such groups on CUDA raise. A
    replayed collective is outside the process group's watchdog: a rank
    that dies mid-replay leaves the others waiting in NCCL's kernels.
    """

    def __init__(self, state: dict, k: int, batch: int, g_cfg: GConfig,
                 ds_cfg: DSConfig, dt_cfg: DTConfig, tc: TrainConfig,
                 seed: int, dtype: torch.dtype, device: torch.device | str,
                 counts: Optional[Callable[[], dict[str, int]]] = None,
                 group=None, time_group=None, shard: Optional[int] = None):
        self.k, self.seed, self.dtype = k, seed, dtype
        self.device = torch.device(device)
        groups = [g for g in (group, time_group) if collectives.size(g) > 1]
        backends = {dist.get_backend(g) for g in groups}
        if self.device.type == "cuda" and backends - {"nccl"}:
            raise NotImplementedError(
                f"--steps_per_call {k} with {sorted(backends)} process "
                f"groups on {self.device}: their collectives run on the "
                f"host, and a CUDA graph cannot hold them; run "
                f"--steps_per_call 1, or one card a rank (nccl)")
        # only where given: a one-process call keeps its signature
        self.groups = {k: g for k, g in (("group", group),
                                         ("time_group", time_group))
                       if g is not None}
        self.shard = shard
        self.cfgs = (g_cfg, ds_cfg, dt_cfg, tc)
        self.counts = counts or dict
        self.state = tru.tree_map(
            lambda v: v.detach().to(self.device, copy=True), state)
        # whole clips: the FP prefix is a slice of them inside the step
        shape = (k, batch, g_cfg.cond_frames + g_cfg.n_frames,
                 g_cfg.img_size, g_cfg.img_size, 3)
        self.reals = torch.zeros(shape, dtype=dtype, device=self.device)
        self.ys = torch.zeros((k, batch), dtype=torch.long, device=self.device)
        self.draws = [HeldDraws(tc.d_steps, batch, g_cfg.z_dim,
                                ds_cfg.k_frames, dtype, self.device)
                      for _ in range(k)]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.metrics: dict[str, torch.Tensor] = {}
        self.launches: dict[str, int] = {}
        self.comms: dict[str, int] = {}
        self.nodes: dict[str, int] = {}
        self.kernel_nodes: Optional[float] = None
        self.marks: list[tuple[str, str]] = []
        self.capture_s: Optional[float] = None   # warm-up + capture, host

    def _steps(self) -> dict[str, torch.Tensor]:
        st, ms = self.state, []
        for j in range(self.k):
            st, m = train_step(st, self.reals[j], self.ys[j], self.draws[j],
                               *self.cfgs, **self.groups)
            ms.append(m)
        _copy_tree(self.state, st)
        return {name: torch.stack([m[name] for m in ms]) for name in ms[0]}

    def _tallies(self) -> tuple[dict[str, int], dict[str, int]]:
        return self.counts(), collectives.COUNTS.snapshot()

    def _per_step(self, before: tuple[dict[str, int], dict[str, int]]
                  ) -> None:
        """`launches` and `comms` a step since the `_tallies()` `before`."""
        self.launches, self.comms = (
            {name: (n - was[name]) // self.k for name, n in now.items()}
            for now, was in zip(self._tallies(), before))

    def warm_up(self) -> dict[str, torch.Tensor]:
        """One eager step from the buffers, its outputs dropped (the step
        writes nothing in place, so the state is as it was), with the
        groups' collectives: the same calls, in the same order and sizes,
        as each step of the capture."""
        return train_step(self.state, self.reals[0], self.ys[0],
                          self.draws[0], *self.cfgs, **self.groups)[1]

    def capture(self) -> None:
        """Warm-up step, then the K steps captured into one CUDA graph
        (`capture_mode()`). No other thread of the caller may issue CUDA
        calls meanwhile: callers capture before their own threads start.
        Under NCCL every rank captures at the same point of its run."""
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not "
                             f"{self.device}")
        if torch.is_anomaly_enabled():
            raise RuntimeError("the K steps cannot be captured into a CUDA "
                               "graph under autograd's anomaly mode")
        t0 = time.perf_counter()
        train = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(train)
        with torch.cuda.stream(side):
            self.warm_up()
        train.wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = self._tallies()
        with profiling.recording_marks() as marks:
            with torch.cuda.graph(graph, capture_error_mode=capture_mode()):
                self.metrics = self._steps()
        self._per_step(before)
        self.marks = marks
        self.nodes = profiling.graph_nodes(graph)
        self.kernel_nodes = (self.nodes["kernel"] - len(marks)) / self.k
        profiling.COUNTERS.kernel_nodes = self.kernel_nodes
        graph.instantiate()
        self.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, state: dict, reals: torch.Tensor, ys: torch.Tensor,
                 start: int) -> tuple[dict, dict[str, torch.Tensor]]:
        """-> (the state after steps start … start + K − 1, their metrics
        stacked (K,)); both are the object's buffers, which the next call
        overwrites."""
        if state is not self.state:
            _copy_tree(self.state, state)
        self.reals.copy_(reals)
        self.ys.copy_(ys)
        g_cfg, ds_cfg = self.cfgs[:2]
        for j, held in enumerate(self.draws):
            held.fill(TorchDraws(self.seed, start + j, self.ys.shape[1],
                                 g_cfg.z_dim, g_cfg.n_frames,
                                 ds_cfg.k_frames, self.dtype, self.device,
                                 shard=self.shard))
        if self.device.type == "cuda":
            if self.graph is None:
                self.capture()
            self.graph.replay()
        else:
            before = self._tallies()
            self.metrics = self._steps()
            self._per_step(before)
        return self.state, self.metrics


@torch.no_grad()
def sample(g_params_ema: dict, g_stats: dict, sn_u: dict, z: torch.Tensor,
           y: torch.Tensor, g_cfg: GConfig,
           cond_video: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The serving path: EMA weights, eval-mode BN (running stats), SN with
    frozen u (one power iteration, u not stored back), everything in the
    compute dtype z.dtype. Returns (B, T, H, W, 3) in [-1, 1]: for FP the
    n_frames generated after the real prefix `cond_video` (B, cond_frames,
    H, W, 3), which is not re-emitted. The span "sample" holds "sn" and
    G's per level ("g.<i>", "g.head"); the host time of the call goes to
    `profiling.COUNTERS`: the process's first call's to `sample_first_s`
    (it builds the kernels and picks cuDNN's plans), every later call's
    to `sample_issue_s`, `sample_calls`."""
    t0 = time.perf_counter()
    with span("sample"):
        g_sn, _ = sn.sn_normalize(g_params_ema, sn_u, update=False,
                                  compute_dtype=z.dtype)
        video, _ = generator.apply(g_sn, g_stats, z, y, g_cfg, train=False,
                                   cond_video=cond_video)
    dt, c = time.perf_counter() - t0, profiling.COUNTERS
    if c.sample_first_s is None:
        c.sample_first_s = dt
    else:
        c.sample_issue_s += dt
        c.sample_calls += 1
    return video
