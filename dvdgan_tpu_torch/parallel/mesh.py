"""Process mesh and the data(/time)-parallel train step — the counterpart of
`dvdgan_tpu/parallel/mesh.py` over `torch.distributed`.

The reference is one SPMD program over a device mesh; the port runs one
process per rank. The mesh is (data,) or (data, time), laid out row-major
as the reference's trainer builds it (`make_mesh((n_data, n_time), ("data",
"time"))`): rank r sits at data index r // n_time and time index
r % n_time, so a rank's time neighbours are the ranks beside it. Each rank
belongs to one data group (the ranks with its time index: BN moments and
the gradient mean) and one time group (the ranks with its data index: DT's
halos and score sum, and the gradient mean again).

How processes start (`cli.py`):

  * `--n_devices N` on one launch spawns N local ranks (`spawn`), one per
    visible card (rank i on cuda:i), or N gloo ranks on the CPU with
    `--device cpu`. `plan` follows the reference trainer's rule
    (`dvdgan_tpu/train/trainer.py:144-169`): 0 means every visible device
    (on the CPU: one), more than are visible raises, `time_shards` above
    the devices raises, and the data ranks shrink until they divide the
    global batch. One rank in all is today's single-process path.
  * `--multihost` initializes from the launcher's environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`, as `torchrun`
    sets them), the counterpart of the reference's
    `jax.distributed.initialize()`; each process takes the device its
    `--device` names, a bare `cuda` meaning cuda:<LOCAL_RANK> (one card a
    rank, as torchrun lays ranks out) and `cuda:<i>` that card, which
    ranks may then share (`rank_device`).

The backend is chosen once, at init, from every rank's device
(`choose_backend`): `nccl` when each rank has a card of its own, `gloo`
when ranks share a card or run on the CPU (NCCL refuses two ranks on one
device). It is printed and never switched afterwards: a failed NCCL init
raises, with no fallback to gloo. The process group gets a finite
timeout, so a rank that dies makes the others fail instead of hang (an
eager collective; a collective replayed from a CUDA graph is outside the
watchdog's sight, `train/step.py:MultiStep`).

Under NCCL (`init_from_env`): the process group is bound to the rank's
card (`device_id`), so the world's communicator is made at init and a
failed init raises there; the data and time groups' are made by their
creation or first collective, before any capture (`MultiStep`'s warm-up
issues every collective of the step: a communicator cannot be made
inside a capture). The ranks of one host move their data card to card
over NVLink, not through the host, and share its cores (`share_cores`).
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import os
import socket
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from dvdgan_tpu_torch.parallel import collectives

DATA_AXIS = "data"
TIME_AXIS = "time"
# a collective that waits longer than this fails the run (the first steps
# include each rank's kernel builds and the long clip's first forward)
DEFAULT_TIMEOUT_S = 900.0
ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The layout of the ranks: `shape` over `axis_names`, row-major."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...] = (DATA_AXIS,)

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match its "
                             f"axes {self.axis_names}")

    @property
    def world(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def size(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)

    def coords(self, rank: int) -> dict[str, int]:
        """{axis: index} of `rank`."""
        out = {}
        for name, s in reversed(list(zip(self.axis_names, self.shape))):
            out[name] = rank % s
            rank //= s
        return out

    def index(self, axis: str, rank: int) -> int:
        return self.coords(rank).get(axis, 0)

    def groups_along(self, axis: str) -> list[list[int]]:
        """Every group of ranks that differ only in `axis`, each in axis
        order, the groups in the order of their lowest rank."""
        groups: dict[tuple, list[int]] = {}
        for r in range(self.world):
            c = self.coords(r)
            key = tuple(v for k, v in c.items() if k != axis)
            groups.setdefault(key, []).append(r)
        return sorted(groups.values())


def local_batch_rows(mesh: Mesh, global_batch: int,
                     ranks: Sequence[int]) -> tuple[int, int]:
    """The contiguous [start, stop) block of the global batch that the
    ranks `ranks` (those of one process) hold: data index d holds rows
    [d·B/n_data, (d+1)·B/n_data), and ranks along `time` hold their data
    index's rows again. Every process computes the same global shuffle and
    decodes only these rows (`Loader(rows=...)`). Raises when the global
    batch does not split over the data axis, or when the process's rows
    have a hole (reorder the mesh so that the data axis keeps a process's
    ranks together)."""
    n_data = mesh.size(DATA_AXIS)
    if global_batch % n_data:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n_data} data ranks")
    per = global_batch // n_data
    ranges = sorted({(mesh.index(DATA_AXIS, r) * per,
                      (mesh.index(DATA_AXIS, r) + 1) * per) for r in ranks})
    if not ranges:
        raise ValueError("this process holds no rank of the mesh")
    pos = ranges[0][0]
    for a, b in ranges:
        if a > pos:
            raise ValueError(
                f"process-local batch rows are not contiguous: {ranges} "
                "(reorder the mesh so the data axis keeps process blocks "
                "contiguous)")
        pos = max(pos, b)
    return ranges[0][0], ranges[-1][1]


def plan(n_devices: int, time_shards: int, batch_size: int,
         device: torch.device) -> tuple[int, int]:
    """(n_data, n_time) of one launch, by the reference trainer's rule."""
    n_time = max(1, time_shards)
    if device.type == "cuda":
        avail = torch.cuda.device_count()
        if n_devices > avail:
            raise ValueError(f"--n_devices {n_devices} > {avail} visible "
                             f"devices")
    else:
        avail = 1
    if n_devices > 0:
        avail = n_devices
    if n_time > 1 and avail < n_time:
        raise ValueError(
            f"time_shards={n_time} needs at least that many devices; have "
            f"{avail} (refusing to silently drop the requested context "
            f"parallelism)")
    n_data = avail // n_time
    while n_data > 1 and batch_size % n_data:
        n_data -= 1
    return n_data, n_time


def device_identity(device: torch.device) -> str:
    """Names the physical device a rank computes on: equal strings mean
    the same card (or the CPU)."""
    if device.type != "cuda":
        return "cpu"
    props = torch.cuda.get_device_properties(device)
    card = getattr(props, "uuid", None)
    if card is None:
        card = ":".join(str(getattr(props, k, "?")) for k in (
            "pci_domain_id", "pci_bus_id", "pci_device_id"))
    return f"{socket.gethostname()}/{card}"


def rank_device(device: torch.device, local_rank: int) -> torch.device:
    """The device of the host's rank `local_rank` under `--device device`:
    a bare `cuda` is cuda:<local_rank>, one card a rank; a named card
    (`cuda:0`) or the CPU is taken as it is, and ranks may share it."""
    if device.type != "cuda" or device.index is not None:
        return device
    n = torch.cuda.device_count()
    if local_rank >= n:
        raise ValueError(f"local rank {local_rank} has no card of its own "
                         f"({n} visible); --device cuda:<i> puts ranks on "
                         f"one card")
    return torch.device("cuda", local_rank)


def choose_backend(identities: Sequence[str]) -> tuple[str, str]:
    """(backend, why) for ranks on the devices `identities` names."""
    if any(i == "cpu" for i in identities):
        return "gloo", "ranks on the CPU"
    if len(set(identities)) < len(identities):
        return "gloo", "ranks share a card (NCCL takes one rank a device)"
    return "nccl", "one card a rank"


@dataclasses.dataclass
class Parallel:
    """This process's rank in the mesh, its device and its groups (None
    for a group of one rank)."""
    mesh: Mesh
    rank: int
    device: torch.device
    backend: str
    data_group: Optional[object]
    time_group: Optional[object]

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def n_data(self) -> int:
        return self.mesh.size(DATA_AXIS)

    @property
    def n_time(self) -> int:
        return self.mesh.size(TIME_AXIS)

    @property
    def data_index(self) -> int:
        return self.mesh.index(DATA_AXIS, self.rank)

    def _comm(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device if self.backend == "nccl" else "cpu")

    def broadcast_int(self, value: Optional[int]) -> Optional[int]:
        """Rank 0's `value` (None allowed) on every rank."""
        t = self._comm(torch.tensor([-1 if value is None else value],
                                    dtype=torch.int64))
        dist.broadcast(t, src=0)
        v = int(t.item())
        return None if v < 0 else v

    def barrier(self) -> None:
        if self.backend == "nccl":      # on this rank's card, not a guess
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def close(self) -> None:
        """Destroys the process group. NCCL's destruction waits until every
        CUDA graph that captured its collectives is freed: callers drop
        theirs first (`Trainer.close`), and a collection pass frees any
        left in reference cycles."""
        if dist.is_initialized():
            gc.collect()
            dist.destroy_process_group()


def init_from_env(device: torch.device, time_shards: int, batch_size: int,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> Parallel:
    """Joins the process group the environment describes (`ENV_KEYS`),
    picks the backend from every rank's device, and builds the mesh and
    its groups. Every rank must call it, with the same `time_shards`."""
    missing = [k for k in ENV_KEYS if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost needs the launcher's environment: "
                           f"{missing} not set")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    n_time = max(1, time_shards)
    if world % n_time:
        raise ValueError(f"{world} ranks do not split into time_shards "
                         f"{n_time}")
    n_data = world // n_time
    if batch_size % n_data:
        raise ValueError(f"global batch {batch_size} does not split over "
                         f"{n_data} data ranks")
    share_cores(int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    device = rank_device(device, int(os.environ["LOCAL_RANK"]))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(os.environ["MASTER_ADDR"],
                          int(os.environ["MASTER_PORT"]), world,
                          is_master=(rank == 0), timeout=timeout)
    store.set(f"device/{rank}", device_identity(device))
    idents = [store.get(f"device/{r}").decode() for r in range(world)]
    backend, why = choose_backend(idents)
    bind = {}
    if backend == "nccl":
        bind = {"device_id": device}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout, **bind)
    mesh = (Mesh((n_data,)) if n_time == 1
            else Mesh((n_data, n_time), (DATA_AXIS, TIME_AXIS)))
    groups = {}
    for axis in (DATA_AXIS, TIME_AXIS):
        if mesh.size(axis) == 1:
            groups[axis] = None
            continue
        for ranks in mesh.groups_along(axis):   # every rank makes every group
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    if rank == 0:
        print(f"parallel: backend {backend} ({why}), {world} ranks, mesh "
              f"data {n_data} x time {n_time}, rank 0 on {device}",
              flush=True)
    return Parallel(mesh, rank, device, backend, groups[DATA_AXIS],
                    groups[TIME_AXIS])


def share_cores(local_ranks: int) -> None:
    """Gives this rank its share of the host's cores for torch's CPU work
    (the seeded init's factorizations, checkpoint copies), unless the
    launcher set OMP_NUM_THREADS (as torchrun does). With a thread pool of
    every core in each of several ranks, OpenMP's spinning threads
    oversubscribe the host: a four-rank flagship train run on four H100s
    of a 32-core host took 156–159 s on pools of every core, 27–86 s with
    its share (`chip_smoke.py --cards 4`)."""
    if "OMP_NUM_THREADS" in os.environ:
        return
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count() or 1)
    torch.set_num_threads(max(1, cores // max(1, local_ranks)))


def free_port() -> int:
    """A TCP port of this host free at the time of the call."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(local_rank: int, fn: Callable, world: int, port: int,
               args: tuple) -> None:
    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local_rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    fn(local_rank, *args)


def spawn(fn: Callable, world: int, args: tuple = (),
          timeout_s: Optional[float] = None) -> None:
    """Runs fn(local_rank, *args) in `world` fresh processes (the spawn
    method) with the launcher environment of a one-host cluster set, and
    waits for all. A rank that fails stops the others and raises here; so
    does a run longer than `timeout_s`. `fn` must be importable by name."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(fn, world, free_port(), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = (None if timeout_s is None
                else datetime.datetime.now()
                + datetime.timedelta(seconds=timeout_s))
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and datetime.datetime.now() > deadline:
                raise TimeoutError(f"{world} ranks still ran after "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()


def replicate_state(state: dict, par: Parallel) -> dict:
    """Rank 0's state on every rank (one broadcast per dtype), so that all
    ranks start from its bits, whether from the seeded init, `--weights` or
    a checkpoint."""
    def bcast(buf: torch.Tensor) -> torch.Tensor:
        comm = par._comm(buf)
        dist.broadcast(comm, src=0)
        return comm.to(buf.device)

    return collectives.map_flat(bcast, state)


def check_clip(g_cfg, n_time: int) -> None:
    """DT's clip (prefix and generated frames) must split over `time`."""
    clip_len = g_cfg.n_frames + g_cfg.cond_frames
    if n_time > 1 and clip_len % n_time:
        raise ValueError(f"clip length {clip_len} not divisible by the time "
                         f"axis ({n_time} shards)")


def step_groups(par: Optional[Parallel]) -> dict:
    """`train_step`'s and `MultiStep`'s `group` and `time_group` of this
    rank: its data and time groups; none for one process."""
    if par is None:
        return {}
    return {"group": par.data_group, "time_group": par.time_group}


def make_parallel_train_step(g_cfg, ds_cfg, dt_cfg, tc,
                             par: Optional[Parallel]) -> Callable:
    """f(state, real, y, draws) -> (state, metrics): `train_step` on this
    rank's rows of the batch with cross-replica BN over the data group, DT
    time-sharded over the time group, and gradients and metrics averaged
    over both; with `par` None, one process's step. `draws` are this
    rank's (`rank_shard`)."""
    from dvdgan_tpu_torch.train import step as step_mod  # it imports parallel

    if par is not None:
        check_clip(g_cfg, par.n_time)
    groups = step_groups(par)

    def run(state, real, y, draws):
        return step_mod.train_step(state, real, y, draws, g_cfg, ds_cfg,
                                   dt_cfg, tc, **groups)
    return run


def rank_shard(par: Optional[Parallel]) -> Optional[int]:
    """The draw fold of this rank: its data index when the data axis has
    more than one rank, else None (today's streams). Time ranks share
    their data index's streams: G and DS are replicated along `time`."""
    if par is None or par.n_data == 1:
        return None
    return par.data_index
