"""The benchmark's inputs, all made from the run's `--seed`: training clips
(a map-style set the program's loader reads), the order in which that
loader hands them out, the sampler's latents and labels, and the weights
of a train state.

The clips are moving squares on a two-tone background whose direction and
speed follow the class, drawn with numpy on the host from (seed, index)
alone; the content does not change the work a step does, only which
numbers it computes. The weights are drawn on the device in one call per
kind of leaf, in f32: kernels N(0, 1/fan_in) (spectral norm divides them
by their top singular value), biases and BN shifts 0, BN scales and
running variances 1, attention γ uniform in [0.1, 0.5], SN u vectors
normalized N(0, 1).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import model as ref

_M64 = (1 << 64) - 1


def derive(seed: int, *salt: int) -> int:
    """A 64-bit seed for one purpose of a run, from the run's seed."""
    x = ref.splitmix64(seed & _M64)
    for s in salt:
        x = ref.splitmix64((x + s) & _M64)
    return x


def program_seed(seed: int) -> int:
    """The seed the program's trainer is given (its noise streams): a
    non-negative 62-bit number whatever the run's seed."""
    return derive(seed, 6) >> 2


def loader_seed(seed: int) -> int:
    """The program's loader shuffles with numpy's 32-bit RandomState at
    seed + epoch: a 31-bit seed of the run leaves room for the epochs."""
    return derive(seed, 1) % (1 << 31)


class ClipSet:
    """(clip (T, H, W, 3) float32 in [-1, 1], label) for index i, the same
    for the same (seed, i) wherever it is read."""

    def __init__(self, n_items: int, n_frames: int, img_size: int,
                 n_classes: int, seed: int):
        self.n_items, self.t, self.size = n_items, n_frames, img_size
        self.n_classes = n_classes
        self.seed = seed

    def __len__(self) -> int:
        return self.n_items

    def __getitem__(self, i: int):
        rng = np.random.RandomState(derive(self.seed, 2, i) % (1 << 32))
        label = int(rng.randint(self.n_classes))
        t, n = self.t, self.size
        angle = 2 * np.pi * label / self.n_classes
        speed = n / 64 * (1 + label % 3)
        sq = max(n // 8, 2)
        x0, y0 = rng.uniform(0, n - sq, size=2)
        fg = rng.uniform(0.2, 1.0, size=3).astype(np.float32)
        bg = rng.uniform(-1.0, -0.2, size=(2, 3)).astype(np.float32)
        clip = np.empty((t, n, n, 3), np.float32)
        clip[:, : n // 2] = bg[0]
        clip[:, n // 2:] = bg[1]
        for f in range(t):
            cx = int(x0 + speed * np.cos(angle) * f) % (n - sq)
            cy = int(y0 + speed * np.sin(angle) * f) % (n - sq)
            clip[f, cy:cy + sq, cx:cx + sq] = fg
        return clip, label


def batch_items(n_items: int, batch: int, seed: int, step: int) -> np.ndarray:
    """The indices of train step `step`'s batch as the program's loader
    orders them (its documented rule: epoch e is a permutation of the set
    by numpy's RandomState(seed + e), cut into whole batches)."""
    per_epoch = n_items // batch
    epoch, j = divmod(step, per_epoch)
    idx = np.arange(n_items)
    np.random.RandomState(loader_seed(seed) + epoch).shuffle(idx)
    return idx[j * batch:(j + 1) * batch]


def batch(clips: ClipSet, idx) -> tuple[np.ndarray, np.ndarray]:
    items = [clips[int(i)] for i in idx]
    return (np.stack([c for c, _ in items]),
            np.asarray([l for _, l in items], np.int64))


def sample_inputs(seed: int, i: int, batch_size: int, z_dim: int,
                  n_classes: int, dtype, device) -> tuple:
    """Batch i of the sampler: z ∼ N(0, 1) in the compute dtype and class
    labels, drawn on the device from (seed, i)."""
    gen = torch.Generator(device).manual_seed(derive(seed, 3, i))
    z = torch.randn(batch_size, z_dim, generator=gen, device=device,
                    dtype=dtype)
    y = torch.randint(0, n_classes, (batch_size,), generator=gen,
                      device=device)
    return z, y


def _fill(shapes: dict, gen, device, kind) -> dict:
    """One draw for every leaf of `shapes` that `kind(path)` names
    'kernel', split into the leaves; the rest filled by rule."""
    kern = {p: s for p, s in shapes.items() if kind(p) == "kernel"}
    n = sum(int(np.prod(s)) for s in kern.values())
    flat = torch.randn(n, generator=gen, device=device)
    out, at = {}, 0
    for p, s in shapes.items():
        k = kind(p)
        if k == "kernel":
            size = int(np.prod(s))
            fan_in = int(np.prod(s[:-1]))
            out[p] = (flat[at:at + size].reshape(s) * fan_in ** -0.5)
            at += size
        elif k == "gamma":
            out[p] = 0.1 + 0.4 * torch.rand(s, generator=gen, device=device)
        elif k == "one":
            out[p] = torch.ones(s, device=device)
        else:
            out[p] = torch.zeros(s, device=device)
    return out


def _kind(path: str) -> str:
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("w", "emb"):
        return "kernel"
    if leaf == "gamma":
        return "gamma"
    if leaf in ("scale", "var"):
        return "one"
    return "zero"


def make_state(spec: "ref.Spec", seed: int, device,
               models=("g", "ds", "dt")) -> dict:
    """The initial train state from the seed, on the device, as flat
    dicts: {"step": 0, "g": {params, stats, sn_u, opt}, "ds", "dt":
    {params, sn_u, opt}, "g_ema"}; opt = {"count", "mu", "nu"}. G comes
    first from the generator, so `models=("g",)` gives the same G."""
    gen = torch.Generator(device).manual_seed(derive(seed, 4))
    shapes = ref.param_shapes(spec)
    st: dict = {"step": 0}
    for m in models:
        params = _fill(shapes[m], gen, device, _kind)
        sn_paths = sorted(p for p in params if ref.is_sn(p))
        outs = [params[p].shape[-1] for p in sn_paths]
        u = torch.randn(sum(outs), generator=gen, device=device)
        sn_u, at = {}, 0
        for p, n in zip(sn_paths, outs):
            v = u[at:at + n]
            sn_u[p] = v / torch.linalg.vector_norm(v)
            at += n
        st[m] = {"params": params, "sn_u": sn_u,
                 "opt": {"count": torch.zeros((), dtype=torch.int32,
                                              device=device),
                         "mu": {p: torch.zeros_like(v)
                                for p, v in params.items()},
                         "nu": {p: torch.zeros_like(v)
                                for p, v in params.items()}}}
        if m == "g":
            st["g"]["stats"] = _fill(ref.stat_shapes(spec), gen, device,
                                     _kind)
    st["g_ema"] = {p: v.clone() for p, v in st["g"]["params"].items()}
    return st


# ------------------------------------------------- trees of the program --

def unflatten(flat: dict) -> object:
    """{'a/0/b': x} -> {'a': [{'b': x}]}: the nested dicts and lists of
    the program's state, a node whose keys are 0 … n−1 a list."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        *parents, last = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: dict = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def to_program(st: dict) -> dict:
    """The flat-dict state as the program's tree (SN u stays a flat dict
    keyed by path, the step an int32 scalar)."""
    dev = st["g"]["params"]["seed/w"].device

    def model(m: dict, stats: bool) -> dict:
        out = {"params": unflatten(m["params"]), "sn_u": dict(m["sn_u"]),
               "opt": {"count": m["opt"]["count"],
                       "mu": unflatten(m["opt"]["mu"]),
                       "nu": unflatten(m["opt"]["nu"])}}
        if stats:
            out["stats"] = unflatten(m["stats"])
        return out

    out = {"step": torch.full((), st["step"], dtype=torch.int32,
                              device=dev),
           "g_ema": unflatten(st["g_ema"])}
    for m in ("g", "ds", "dt"):
        if m in st:
            out[m] = model(st[m], m == "g")
    return out
