"""The four-card rates' schedule on rank 0 (`chip_smoke.card_rates_rank`),
on the CPU in a one-rank gloo group with stand-in trainers.

On the card a trainer keeps its K-step graph's private pool from its
capture until it is closed. The long clip's one-card trainer (batch 8 as
4 micro-batches, its fake pass at 16) reserved ~44 GiB for its K 2 graph,
its eager K 1 step needs ~20 GiB more, and the ranks' trainer (batch 2)
~13 GiB for its graph: on rank 0's 79.18 GiB card the one card's K 1
reading ran out of memory beside both graphs (one H100 in a one-rank NCCL
group, `tools/torch_card_rates_one.py`), and, with four ranks' NCCL
buffers on the card, beside its own graph alone (`chip_smoke.py --cards
4`; ROADMAP.md Queue 3). So on rank 0, for every entry of CARD_RATES:

  * every reading of RATE_TURNS runs, in order, on the trainer it names;
  * when the one card's trainer reads at K 1, no K graph is alive;
  * when it captures its K graph (its first K turn), no ranks' trainer is
    alive;
  * every trainer is closed by the end of its entry; each entry's row,
    with both sides' profiled K call, is written.
"""

from __future__ import annotations

import json
import sys

import torch

import chip_smoke
from dvdgan_tpu_torch.parallel import mesh as pmesh


class FakeMulti:
    comms = {"all_reduce": 0, "all_gather": 0, "bytes": 0}
    capture_s = 0.0
    state = reals = ys = None

    class graph:
        @staticmethod
        def replay():
            pass

    def __call__(self, *args):
        return None, {}


class FakeTrainer:
    """What `card_rates_rank` and `_rate_trainer` touch of a `Trainer`:
    its first `train` at K > 1 captures (a graph from then until `close`).
    `train` appends (side, K, graphs alive, ranks' trainers alive) to
    `log`; `alive` holds the trainers not yet closed."""
    log: list = []
    alive: list = []

    def __init__(self, cfg, par=None):
        self.side = "one" if par is None else "ranks"
        self.start_step, self.steps_per_call = 0, cfg.steps_per_call
        self.is_main, self.out_dir, self._multi = True, "", None
        self.alive.append(self)

    def train(self, total_step: int) -> None:
        if self.steps_per_call > 1 and self._multi is None:
            self._multi = FakeMulti()
            ranks = sum(t.side == "ranks" for t in self.alive)
            self.log.append((self.side, "capture", None, ranks))
        graphs = sum(t._multi is not None for t in self.alive)
        ranks = sum(t.side == "ranks" for t in self.alive)
        self.log.append((self.side, self.steps_per_call, graphs, ranks))
        self.start_step = total_step

    def close(self) -> None:
        self._multi = None
        self.alive.remove(self)


def test_rank0_reads_the_one_card_at_k1_with_no_graph_alive(tmp_path,
                                                             monkeypatch):
    from dvdgan_tpu_torch.train import trainer as trainer_mod

    log, alive = [], []
    monkeypatch.setattr(FakeTrainer, "log", log)
    monkeypatch.setattr(FakeTrainer, "alive", alive)
    monkeypatch.setattr(trainer_mod, "Trainer", FakeTrainer)
    monkeypatch.setattr(chip_smoke, "steady_ms", lambda *a: [1.0])
    monkeypatch.setattr(chip_smoke, "profile_kernels", lambda fn: {
        "device_ms": 1.0, "nccl_ms": 0.0, "nccl_launches": 0})
    for fn in ("set_sync_debug_mode", "synchronize",
               "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    for fn in ("memory_allocated", "max_memory_allocated", "memory_reserved"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: 0)
    monkeypatch.setattr(sys, "stdout", sys.stdout)   # the rank redirects it
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    for key, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(pmesh.free_port())).items():
        monkeypatch.setenv(key, v)
    chip_smoke.card_rates_rank(0, str(tmp_path), cards=1, device="cpu")

    rates = chip_smoke.CARD_RATES
    # each trainer's warm-up at K 1 at its first turn, then the readings
    reads = [(side, kk) for side, kk, _, _ in log if kk != "capture"]
    want = []
    for _, _, k, _ in rates.values():
        seen = set()
        for side, kk in chip_smoke.RATE_TURNS:
            if side not in seen:
                seen.add(side)
                want.append((side, 1))
            want.append((side, k if kk == "K" else kk))
    assert reads == want
    # its warm-up and its reading
    assert [graphs for side, kk, graphs, _ in log if (side, kk) == ("one", 1)
            ] == [0] * 2 * len(rates)
    assert [ranks for side, kk, _, ranks in log
            if (side, kk) == ("one", "capture")] == [0] * len(rates)
    assert not alive
    with open(tmp_path / "rates_rank0.json") as f:
        rows = json.load(f)
    assert rows.keys() == rates.keys()
    assert all({"turns", "one", "ranks"} <= row.keys() for row in rows.values())
