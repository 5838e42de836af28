"""The numbers that decide `correct`, from the program's outputs and the
plain reference's.

Training. Set-up hands the trainer the benchmark's weights at step
`ema_start` (so EMA's decay runs) and runs its first call of K steps
(call 1: the CUDA graph's capture and a replay); the reference follows
the same K steps in f32 from the same weights, clips and noise. Leaves
whose gradient over the call in the reference is flat (√ν under
FLAT_LEAF of the median leaf's: the biases before a batch norm, which Adam
moves by round-off alone, and a D whose hinge losses saturate in every
step) are left out by that rule. Compared:

  call1_count     Adam's update count after the call against K for G and
                  K·d_steps for DS and DT, the differences summed (exact);
  call1_unmoved   the leaves of G, DS and DT the call left as they were
                  made (exact; EMA's steps of 1e-4 move a leaf near 1 by
                  an ulp or none, so EMA is change_ema's);
  stats_gap       G's batch-norm running moments after the call, which
                  every G update's forward writes, ‖program − reference‖ /
                  ‖reference − as made‖: the median leaf;
  stats_worst     the same, the worst leaf (a fault in one level's GRU or
                  block);
  change_<m>      for G, DS, DT and G's EMA ("ema"): |‖Δ program‖ −
                  ‖Δ reference‖| / max(‖Δ reference‖, the median leaf's),
                  Δ the change over the call: the median leaf;
  turn_<m>        for G, DS, DT: 1 − cos(Δ program, Δ reference), the
                  median leaf (a gradient of the wrong sign);
  grad_<m>        for G, DS, DT: the gap of the norms of √ν, Adam's second
                  moment after the call (the gradients' root mean square
                  over its steps), as for change_<m>: the median leaf.

Worst-leaf changes and gradients, and the losses, are not compared: they
swing from seed to seed with the bf16 rounding of the steps before them
(`PERF.md` gives the readings, and those of the program's own f32 path
and of a bf16-rounded reference that show the cause; `calibrate.py`
prints them).

Sampling (batches drawn from the seed among those the window served):

  clip_gap        the largest |program − reference| over their clips;
  clip_rms_gap    ‖program − reference‖ / ‖reference‖ over them.
"""

from __future__ import annotations

import statistics

import torch

FLAT_LEAF = 1e-3        # share of the median leaf's first gradient
LOSSES = ("d_loss", "g_loss")
METRICS = ("d_loss", "d_loss_s", "d_loss_t", "g_loss")
MODELS = ("g", "ds", "dt")
ENDS = ("g", "ds", "dt", "g_ema")


def _norms(tree: dict) -> dict[str, float]:
    return {p: float(torch.linalg.vector_norm(v.double()))
            for p, v in tree.items()}


def leaf_gaps(prog: dict, ref: dict) -> dict[str, float]:
    """{leaf: |‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)}."""
    pn, rn = _norms(prog), _norms(ref)
    if not rn:
        return {}
    med = statistics.median(rn.values())
    return {p: abs(pn[p] - r) / max(r, med, 1e-30) for p, r in rn.items()}


def joined(trees: dict, models=MODELS) -> dict:
    """{model/path: leaf} over the models' flat trees; G's EMA is its own
    model "g_ema"."""
    return {f"{m}/{p}": v for m in models for p, v in trees[m].items()}


def flat_leaves(nu: dict) -> set[str]:
    """The leaves whose gradient over the call, the norm of √ν as Adam
    holds it, is under FLAT_LEAF of the median leaf's, as model/path; G's
    flat leaves are flat in its EMA too. A D whose hinge losses saturate
    in every step of the call is flat whole."""
    rms = _norms({p: v.sqrt() for p, v in joined(nu).items()})
    med = statistics.median(rms.values())
    flat = {p for p, v in rms.items() if v < FLAT_LEAF * med}
    return flat | {"g_ema/" + p[2:] for p in flat if p.startswith("g/")}


def _median(values) -> float:
    """The median; 0 where the reference moved no leaf of the model."""
    values = list(values)
    return statistics.median(values) if values else 0.0


def stats_gaps(prog: dict, ref: dict, made: dict) -> dict[str, float]:
    """{leaf: ‖prog − ref‖ / ‖ref − made‖} of G's running moments."""
    return {p: float((prog[p] - r).double().norm()
                     / (r - made[p]).double().norm().clamp(min=1e-30))
            for p, r in ref.items()}


def turns(prog: dict, ref: dict) -> dict[str, float]:
    """{leaf: 1 − cos(prog, ref)} over the leaves the reference moves; a
    leaf of zeros on the program's side reads 1."""
    return {p: 1.0 - float(torch.nn.functional.cosine_similarity(
        prog[p].flatten().double(), r.flatten().double(), dim=0, eps=1e-30))
        for p, r in ref.items() if bool(r.any())}


NAMES = {"g": "g", "ds": "ds", "dt": "dt", "g_ema": "ema"}


def train_numbers(expected: dict[str, int], prog: dict, ref: dict,
                  made: dict) -> dict[str, float]:
    """expected {model: Adam's update count after the call}; prog: {"count":
    {model: int}, "end": {model: flat}, "stats": flat, "nu": {model:
    flat}}; ref: the same without "count"; made: {"end", "stats"} as the
    benchmark made them. "end" holds G, DS, DT and "g_ema". Tensors on one
    device."""
    flat = flat_leaves(ref["nu"])
    done = joined(prog["end"])
    unmoved = sum(1 for p, v in joined(made["end"]).items()
                  if p not in flat and torch.equal(v, done[p]))
    gaps = stats_gaps(prog["stats"], ref["stats"], made["stats"])
    out = {"call1_count": float(sum(abs(prog["count"][m] - n)
                                    for m, n in expected.items())),
           "call1_unmoved": float(unmoved),
           "stats_gap": statistics.median(gaps.values()),
           "stats_worst": max(gaps.values())}
    for m in ENDS:
        keep = {p for p in ref["end"][m] if f"{m}/{p}" not in flat}
        base = made["end"][m]
        dp = {p: prog["end"][m][p] - base[p] for p in keep}
        dr = {p: ref["end"][m][p] - base[p] for p in keep}
        out[f"change_{NAMES[m]}"] = _median(leaf_gaps(dp, dr).values())
        if m in MODELS:
            out[f"turn_{m}"] = _median(turns(dp, dr).values())
            root = lambda t: {p: t[m][p].sqrt() for p in keep}
            out[f"grad_{m}"] = _median(
                leaf_gaps(root(prog["nu"]), root(ref["nu"])).values())
    return out


def clip_numbers(pairs: list[tuple[torch.Tensor, torch.Tensor]]
                 ) -> dict[str, float]:
    """pairs of (program clips, reference clips), f32 on one device."""
    worst, num, den = 0.0, 0.0, 0.0
    for p, r in pairs:
        d = (p - r).double()
        worst = max(worst, float(d.abs().max()))
        num += float((d * d).sum())
        den += float((r.double() ** 2).sum())
    return {"clip_gap": worst, "clip_rms_gap": (num / max(den, 1e-30)) ** 0.5}
