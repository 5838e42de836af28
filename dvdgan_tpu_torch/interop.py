"""Carrying generator weights between `dvdgan_tpu` and the port.

The exchange format is a flat {path: numpy array} dict under the paths the
reference's `core/tree.flatten_with_paths` gives its train state:

    g_ema/<param path>      EMA-G parameters (e.g. g_ema/levels/0/gru/gates_x/w)
    g/stats/<stats path>    G's BN running moments (g/stats/out_bn/mean)
    g/sn_u/<param path>     G's SN u vectors (g/sn_u/seed/w)

The port keeps the reference's layouts in its trees (HWIO conv kernels,
(in, out) linears), so the arrays cross unchanged; `ops.layers.conv2d`
reorders to OIHW at the `F.conv2d` call. Written as an npz, the same dict
holds the port's own checkpoints of the sampling state.
"""

from __future__ import annotations

import numpy as np
import torch

from dvdgan_tpu_torch.core import tree as tru
from dvdgan_tpu_torch.models.generator import GeneratorState

_PARAMS, _STATS, _SN_U = "g_ema/", "g/stats/", "g/sn_u/"


def _subtree(flat: dict, prefix: str) -> dict[str, torch.Tensor]:
    out = {k[len(prefix):]: torch.from_numpy(np.array(v, np.float32))
           for k, v in flat.items() if k.startswith(prefix)}
    if not out:
        raise KeyError(f"no '{prefix}*' arrays in the generator state")
    return out


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
