"""Migration to and from PyTorch state dicts — the counterpart of the
reference's `tools/import_torch_checkpoint.py` and
`tools/export_torch_checkpoint.py`.

Users of PyTorch DVD-GAN implementations keep G, EMA-G, DS and DT as
state dicts. The interchange naming is the module layout the reference
documents with its PyTorch twin (NCHW modules, concat-kernel ConvGRU,
`nn.BatchNorm2d`):

    G   embed.weight; seed.{weight,bias}
        grus.<i>.{gates,cand}.{weight,bias}   concat kernels: input channels
                                              [0, C) read x, [C, 2C) read h
                                              (r⊙h for cand); biases on x
        blocks.<i>.cbn{1,2}.{gamma,beta}.weight
        blocks.<i>.cbn{1,2}.bn.{running_mean,running_var,num_batches_tracked}
        blocks.<i>.{conv1,conv2,skip}.{weight,bias}
        attn.{spatial,temporal}.{theta,phi,g,out}.weight, attn.*.gamma
        fp_enc.stages.<j>.{weight,bias}       (DVD-GAN-FP)
        out_bn.{weight,bias,running_mean,running_var,num_batches_tracked}
        out_conv.{weight,bias}
    DS  blocks.<i>.{conv1,conv2,skip}.{weight,bias}; head.psi.{weight,bias};
        head.proj.weight
    DT  the same; blocks.<i> for i < n_3d_blocks are Conv3d

Layouts: conv2d HWIO <-> OIHW, conv3d DHWIO <-> OIDHW, linear (in, out)
<-> (out, in); embeddings, vectors and γ as they are; the BN running var
is copied verbatim (both sides normalize with the stored value).

The key map is derived from the port's own parameter trees (those of
`train.state.create` for the config): every leaf of them has exactly one
place in a state dict, and a state dict must hold exactly those keys. A
missing key, an extra key or a wrong shape raises and names the key (what
`load_state_dict(strict=True)` gives the reference's tool), and a leaf of
the port's trees with no place in the naming raises instead of being left
out. `num_batches_tracked` is written (0, as a fresh module holds it) and
accepted and ignored on the way in.

Precision: state dicts of other repositories may be bf16 or f16; every
tensor is cast to float32 on the way in (the port's master parameters are
f32), and `from_port` writes float32.

torch, numpy and the standard library only; the CLIs are
`tools/torch_import_checkpoint.py` and `tools/torch_export_checkpoint.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from dvdgan_tpu_torch.core import tree as tru
from dvdgan_tpu_torch.models import DSConfig, DTConfig, GConfig, generator
from dvdgan_tpu_torch.ops import spectral_norm as sn
from dvdgan_tpu_torch.train import state as train_state

MODELS = ("G", "G_ema", "DS", "DT")
_LEAVES = {"w": "weight", "b": "bias", "emb": "weight", "scale": "weight",
           "bias": "bias", "gamma": "gamma"}
_STATS = {"mean": "running_mean", "var": "running_var"}
_COUNT = "num_batches_tracked"
# a ConvGRU's concat kernels from the port's hoisted halves (x, h)
_GRU = {"gates": ("gates_x", "gates_h"), "cand": ("cand_x", "cand_h")}


@dataclasses.dataclass(frozen=True)
class Entry:
    """One state-dict tensor: its key, the port leaves it is made of (by
    path in the params or stats tree) and the layout between them."""
    key: str
    paths: tuple[str, ...]
    layout: str     # id | linear | conv2d | conv3d | gru


def _to_sd(layout: str, leaves: list[torch.Tensor]) -> torch.Tensor:
    if layout == "gru":
        return torch.cat([x.permute(3, 2, 0, 1) for x in leaves], dim=1)
    x, = leaves
    if layout == "linear":
        return x.T
    if layout == "conv2d":
        return x.permute(3, 2, 0, 1)
    if layout == "conv3d":
        return x.permute(4, 3, 0, 1, 2)
    return x


def _to_port(layout: str, t: torch.Tensor) -> list[torch.Tensor]:
    if layout == "gru":
        c = t.shape[1] // 2
        return [t[:, :c].permute(2, 3, 1, 0), t[:, c:].permute(2, 3, 1, 0)]
    if layout == "linear":
        return [t.T]
    if layout == "conv2d":
        return [t.permute(2, 3, 1, 0)]
    if layout == "conv3d":
        return [t.permute(2, 3, 4, 1, 0)]
    return [t]


def _fail(model: str, path: str, why: str) -> None:
    raise ValueError(f"{model}: the port's leaf '{path}' {why}")


def _module(model: str, parts: list[str]) -> list[str]:
    """The state-dict module path of a port path's module parts."""
    if model == "G" and parts[:1] == ["levels"]:
        if len(parts) < 3 or parts[2] != "block":
            _fail(model, "/".join(parts), "has no place in the naming")
        return ["blocks", parts[1]] + parts[3:]
    return parts


def _layout(model: str, path: str, leaf: str, ndim: int,
            n_3d_blocks: int) -> str:
    if leaf != "w":
        return "id"
    layout = {2: "linear", 4: "conv2d", 5: "conv3d"}.get(ndim)
    if layout is None:
        _fail(model, path, f"is a {ndim}-D kernel")
    parts = path.split("/")
    if model == "DT" and parts[0] == "blocks":
        want = "conv3d" if int(parts[1]) < n_3d_blocks else "conv2d"
        if layout != want:
            _fail(model, path, f"is {layout} where block {parts[1]} of "
                               f"n_3d_blocks {n_3d_blocks} is {want}")
    return layout


def key_map(model: str, params: Any, stats: Any = None,
            n_3d_blocks: int = 0) -> list[Entry]:
    """The entries of `model`'s ("G", "DS" or "DT") state dict from the
    port's params (and G's BN stats) tree; raises ValueError naming a leaf
    that has no place in the naming."""
    entries, grus = [], {}
    for path, x in tru.flatten_with_paths(params).items():
        parts = path.split("/")
        if model == "G" and parts[:1] == ["levels"] and parts[2:3] == ["gru"]:
            grus.setdefault(parts[1], {})["/".join(parts[3:])] = path
            continue
        leaf = parts[-1]
        if leaf not in _LEAVES or (leaf == "gamma" and "attn" not in parts):
            _fail(model, path, "has no place in the naming")
        entries.append(Entry(
            ".".join(_module(model, parts[:-1]) + [_LEAVES[leaf]]), (path,),
            _layout(model, path, leaf, x.dim(), n_3d_blocks)))
    want = {f"{h}/w" for pair in _GRU.values() for h in pair} | {
        f"{x}/b" for x, _ in _GRU.values()}
    for i, halves in grus.items():
        for extra in sorted(halves.keys() - want):
            _fail(model, halves[extra], "has no place in the naming "
                                        "(a concat-kernel GRU: biases on x)")
        for missing in sorted(want - halves.keys()):
            _fail(model, f"levels/{i}/gru/{missing}", "is missing")
        for conv, (xh, hh) in _GRU.items():
            entries.append(Entry(f"grus.{i}.{conv}.weight",
                                 (halves[f"{xh}/w"], halves[f"{hh}/w"]),
                                 "gru"))
            entries.append(Entry(f"grus.{i}.{conv}.bias",
                                 (halves[f"{xh}/b"],), "id"))
    for path in tru.flatten_with_paths(stats if stats is not None else {}):
        parts = path.split("/")
        if parts[-1] not in _STATS:
            _fail(model, path, "has no place in the naming")
        mod = (["blocks", parts[1], "cbn" + parts[2][-1], "bn"]
               if parts[0] == "levels" and parts[2] in ("bn1", "bn2")
               else parts[:-1])
        entries.append(Entry(".".join(mod + [_STATS[parts[-1]]]),
                             ("stats:" + path,), "id"))
    return entries


def _count_keys(entries: list[Entry]) -> list[str]:
    """num_batches_tracked of every BN module the entries hold."""
    return [e.key[:-len("running_mean")] + _COUNT for e in entries
            if e.key.endswith(".running_mean")]


def _templates(g_cfg: GConfig, ds_cfg: DSConfig, dt_cfg: DTConfig) -> dict:
    """{model: (params, stats)} of `train.state.create` for the configs."""
    state = train_state.create(0, g_cfg, ds_cfg, dt_cfg)
    return {"G": (state["g"]["params"], state["g"]["stats"]),
            "DS": (state["ds"]["params"], None),
            "DT": (state["dt"]["params"], None)}


def _leaves(params: Any, stats: Any) -> dict[str, torch.Tensor]:
    flat = dict(tru.flatten_with_paths(params))
    if stats is not None:
        flat.update({"stats:" + k: v for k, v in
                     tru.flatten_with_paths(stats).items()})
    return flat


def _check_tree(model: str, got: Any, want: Any, what: str) -> None:
    g, w = tru.flatten_with_paths(got), tru.flatten_with_paths(want)
    off = sorted(g.keys() ^ w.keys())
    if off:
        raise ValueError(f"{model} {what}: '{off[0]}' is "
                         f"{'missing' if off[0] in w else 'not in the model'}")
    for k, v in w.items():
        if tuple(g[k].shape) != tuple(v.shape):
            raise ValueError(f"{model} {what}: '{k}' is "
                             f"{list(g[k].shape)}, the model's "
                             f"{list(v.shape)}")


def _from_port_model(model: str, params: Any, stats: Any, n_3d: int
                     ) -> dict[str, torch.Tensor]:
    entries = key_map(model.split("_")[0], params, stats, n_3d)
    flat = _leaves(params, stats)
    sd = {e.key: _to_sd(e.layout, [flat[p].detach() for p in e.paths]).to(
        "cpu", torch.float32).contiguous() for e in entries}
    for k in _count_keys(entries):
        sd[k] = torch.tensor(0, dtype=torch.long)
    return sd


def from_port(state: dict, g_cfg: GConfig, ds_cfg: DSConfig,
              dt_cfg: DTConfig) -> dict[str, dict[str, torch.Tensor]]:
    """{"G", "G_ema", "DS", "DT"}: the port train state's models as state
    dicts in the interchange naming (contiguous float32 CPU tensors; G_ema
    with G's BN stats). The state's trees must be the config's."""
    tmpl = _templates(g_cfg, ds_cfg, dt_cfg)
    _check_tree("G", state["g"]["params"], tmpl["G"][0], "params")
    _check_tree("G", state["g"]["stats"], tmpl["G"][1], "stats")
    _check_tree("G_ema", state["g_ema"], tmpl["G"][0], "params")
    _check_tree("DS", state["ds"]["params"], tmpl["DS"][0], "params")
    _check_tree("DT", state["dt"]["params"], tmpl["DT"][0], "params")
    stats = state["g"]["stats"]
    return {
        "G": _from_port_model("G", state["g"]["params"], stats, 0),
        "G_ema": _from_port_model("G_ema", state["g_ema"], stats, 0),
        "DS": _from_port_model("DS", state["ds"]["params"], None, 0),
        "DT": _from_port_model("DT", state["dt"]["params"], None,
                               dt_cfg.n_3d_blocks),
    }


def _to_port_model(model: str, sd: dict[str, torch.Tensor], params: Any,
                   stats: Any, n_3d: int) -> tuple[Any, Any]:
    entries = key_map(model.split("_")[0], params, stats, n_3d)
    want = {e.key for e in entries}
    missing = sorted(want - sd.keys())
    extra = sorted(sd.keys() - want - set(_count_keys(entries)))
    if missing or extra:
        raise KeyError(f"{model} state dict: missing keys {missing[:8]}, "
                       f"unexpected keys {extra[:8]}")
    tmpl = _leaves(params, stats)
    out = {}
    for e in entries:
        t = torch.as_tensor(sd[e.key]).detach().to("cpu", torch.float32,
                                                    copy=True)
        shape = _to_sd(e.layout, [tmpl[p] for p in e.paths]).shape
        if t.shape != shape:
            raise ValueError(f"{model} state dict: '{e.key}' is "
                             f"{list(t.shape)}, the model's {list(shape)}")
        for p, x in zip(e.paths, _to_port(e.layout, t)):
            out[p] = x.contiguous()
    new_params = tru.map_with_path(lambda p, _: out[p], params)
    new_stats = (None if stats is None else
                 tru.map_with_path(lambda p, _: out["stats:" + p], stats))
    return new_params, new_stats


def generator_to_port(g_sd: dict, g_cfg: GConfig, model: str = "G_ema"
                      ) -> tuple[Any, Any]:
    """(params, stats) of a G or EMA-G state dict alone, float32 trees
    (the template is `generator.init`, as `train.state.create` makes G)."""
    params, stats = generator.init(torch.Generator().manual_seed(0), g_cfg)
    return _to_port_model(model, g_sd, params, stats, 0)


def to_port(g_sd: dict, ds_sd: dict, dt_sd: dict, g_cfg: GConfig,
            ds_cfg: DSConfig, dt_cfg: DTConfig) -> tuple[Any, Any, Any, Any]:
    """State dicts in the interchange naming -> (G's params, G's BN stats,
    DS's params, DT's params) as the port's float32 trees."""
    tmpl = _templates(g_cfg, ds_cfg, dt_cfg)
    g_params, g_stats = _to_port_model("G", g_sd, *tmpl["G"], 0)
    ds_params, _ = _to_port_model("DS", ds_sd, tmpl["DS"][0], None, 0)
    dt_params, _ = _to_port_model("DT", dt_sd, tmpl["DT"][0], None,
                                  dt_cfg.n_3d_blocks)
    return g_params, g_stats, ds_params, dt_params


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A state dict from `.pth`/`.pt` (`torch.load(weights_only=True)`,
    a {"state_dict": ...} container unwrapped) or `.npz`. Spectral-norm
    wrapper keys: `*.weight_orig` is the weight, `*.weight_u` and
    `*.weight_v` are dropped (`build_state` converges fresh u)."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            raw = {k: torch.from_numpy(f[k]) for k in f.files}
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and isinstance(raw.get("state_dict"), dict):
            raw = raw["state_dict"]
    sd = {}
    for k, v in raw.items():
        if k.endswith((".weight_u", ".weight_v")):
            continue
        if k.endswith(".weight_orig"):
            k = k[:-len("_orig")]
        sd[k] = v
    return sd


def build_state(cfg, g_params: Any, g_stats: Any, ds_params: Any,
                dt_params: Any, g_ema: Any = None, step: int = 0,
                sn_warmup: int = 30, sn_u: Optional[dict] = None) -> dict:
    """The port's train state (`train.state.create` of `cfg`) around
    imported params: fresh Adam, EMA copied from G unless `g_ema` is given,
    the step, and each model's SN u (the seeded fresh draws, or `sn_u`
    {"g", "ds", "dt": {path: u}}) advanced by `sn_warmup` power iterations
    against the imported weights, so that σ is converged at the first
    resumed step."""
    g_cfg, ds_cfg, dt_cfg = cfg.g_config(), cfg.ds_config(), cfg.dt_config()
    state = train_state.create(cfg.seed, g_cfg, ds_cfg, dt_cfg)
    _check_tree("G", g_params, state["g"]["params"], "params")
    _check_tree("G", g_stats, state["g"]["stats"], "stats")
    _check_tree("DS", ds_params, state["ds"]["params"], "params")
    _check_tree("DT", dt_params, state["dt"]["params"], "params")
    if g_ema is not None:
        _check_tree("G_ema", g_ema, state["g"]["params"], "params")
    f32 = lambda tree: tru.tree_map(  # noqa: E731
        lambda t: t.detach().to("cpu", torch.float32, copy=True), tree)
    for m, params in (("g", g_params), ("ds", ds_params), ("dt", dt_params)):
        params = f32(params)
        u = state[m]["sn_u"] if sn_u is None else f32(sn_u[m])
        if sn_warmup > 0:
            _, u = sn.sn_normalize(params, u, update=True, n_iter=sn_warmup)
        state[m].update(params=params, sn_u=u,
                        opt=train_state.adam_init(params))
    state["g"]["stats"] = f32(g_stats)
    state["g_ema"] = f32(g_params if g_ema is None else g_ema)
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return state
