"""Carrying state between `dvdgan_tpu` and the port.

The exchange format is a flat {path: numpy array} dict under the paths the
reference's `core/tree.flatten_with_paths` gives its train state:

    step                     int32 scalar
    g/params/<param path>    G's parameters (g/params/levels/0/gru/gates_x/w)
    g/stats/<stats path>     G's BN running moments (g/stats/out_bn/mean)
    g/sn_u/<param path>      G's SN u vectors (g/sn_u/seed/w)
    g/opt/0/count            optax Adam state (ScaleByAdamState is element
    g/opt/0/mu/<param path>  0 of the (scale_by_adam, scale) chain state;
    g/opt/0/nu/<param path>  the scale's EmptyState has no leaves)
    ds/{params,sn_u,opt}/…   DS, likewise; dt/… DT
    g_ema/<param path>       EMA-G parameters

The sampling state is the g_ema, g/stats and g/sn_u part of it. The port
keeps the reference's layouts in its trees (HWIO and DHWIO conv kernels,
(in, out) linears), so the arrays cross unchanged; `ops.layers` reorders at
the `F.conv2d`/`F.conv3d` call. Written as an npz, the same dict holds the
port's own checkpoints.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from dvdgan_tpu_torch.core import tree as tru
from dvdgan_tpu_torch.models.generator import GeneratorState

_PARAMS, _STATS, _SN_U = "g_ema/", "g/stats/", "g/sn_u/"
_MODELS = ("g", "ds", "dt")
_ADAM = "opt/0/"


def _subtree(flat: dict, prefix: str) -> dict[str, torch.Tensor]:
    out = {k[len(prefix):]: torch.from_numpy(np.array(v, np.float32))
           for k, v in flat.items() if k.startswith(prefix)}
    if not out:
        raise KeyError(f"no '{prefix}*' arrays in the state")
    return out


def _int32(flat: dict, key: str) -> torch.Tensor:
    if key not in flat:
        raise KeyError(f"no '{key}' array in the train state")
    return torch.from_numpy(np.array(flat[key], np.int32))


def load_generator_state(flat: dict[str, np.ndarray]) -> GeneratorState:
    """The port's GeneratorState (on the CPU) from the reference's flat
    numpy leaves; other entries of `flat` (D, optimizer state) are ignored."""
    return GeneratorState(tru.unflatten(_subtree(flat, _PARAMS)),
                          tru.unflatten(_subtree(flat, _STATS)),
                          _subtree(flat, _SN_U))


def generator_state_to_flat(state: GeneratorState) -> dict[str, np.ndarray]:
    params, stats, sn_u = state.trees()
    flat = {}
    for prefix, leaves in ((_PARAMS, tru.flatten_with_paths(params)),
                           (_STATS, tru.flatten_with_paths(stats)),
                           (_SN_U, sn_u)):
        flat.update({prefix + k: v.detach().float().cpu().numpy()
                     for k, v in leaves.items()})
    return flat


def save_state_npz(path: str, state: GeneratorState) -> None:
    np.savez(path, **generator_state_to_flat(state))


def load_state_npz(path: str) -> GeneratorState:
    with np.load(path) as f:
        return load_generator_state({k: f[k] for k in f.files})


def load_train_state(flat: dict[str, np.ndarray]) -> dict:
    """The port's train state (`train.state`, on the CPU) from the
    reference's flat numpy leaves."""
    state: dict = {"step": _int32(flat, "step"),
                   "g_ema": tru.unflatten(_subtree(flat, _PARAMS))}
    for m in _MODELS:
        opt = f"{m}/{_ADAM}"
        state[m] = {
            "params": tru.unflatten(_subtree(flat, f"{m}/params/")),
            "sn_u": _subtree(flat, f"{m}/sn_u/"),
            "opt": {"count": _int32(flat, opt + "count"),
                    "mu": tru.unflatten(_subtree(flat, opt + "mu/")),
                    "nu": tru.unflatten(_subtree(flat, opt + "nu/"))},
        }
    state["g"]["stats"] = tru.unflatten(_subtree(flat, _STATS))
    return state


def train_state_paths(state: dict) -> dict[str, torch.Tensor]:
    """{reference path: tensor} of the train state, where it lies."""
    tree = dict(state)
    for m in _MODELS:
        tree[m] = dict(state[m], opt=[state[m]["opt"]])  # opt/0/...
    return tru.flatten_with_paths(tree)


def flat_dtype(v: torch.Tensor) -> torch.dtype:
    """The exchange dtype of a leaf: float32, or int32 (step, counts)."""
    return torch.float32 if v.is_floating_point() else torch.int32


def train_state_to_flat(state: dict) -> dict[str, np.ndarray]:
    """Inverse of load_train_state: float leaves as float32, step and the
    Adam counts as int32."""
    return {path: v.detach().to("cpu", flat_dtype(v)).numpy()
            for path, v in train_state_paths(state).items()}


def save_train_state_npz(path: str, state: dict) -> None:
    np.savez(path, **train_state_to_flat(state))


def load_train_state_npz(path: str) -> dict:
    with np.load(path) as f:
        return load_train_state({k: f[k] for k in f.files})


def state_digest(state: dict) -> tuple[str, int]:
    """(sha256 hex, leaves) of a train state's flat arrays, path and bytes
    in path order: equal digests mean bitwise equal states (the ranks of a
    parallel run print theirs)."""
    h = hashlib.sha256()
    flat = train_state_to_flat(state)
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k]).tobytes())
    return h.hexdigest(), len(flat)
