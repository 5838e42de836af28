"""Parameter-tree paths — the counterpart of `dvdgan_tpu/core/tree.py`.

The port keeps the reference's trees: nested dicts and lists of tensors,
addressed by slash-joined paths ("levels/0/gru/gates_x/w"). Parameters and
mutable state (SN `u`, BN running moments) stay in separate trees, so the
forward functions are pure. `to_module` hangs a tree on an `nn.Module` (for
`.to(device)`, `state_dict()` and `named_parameters()`), whose attribute
paths are the same paths with "." for "/".
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn


def flatten_with_paths(tree: Any, prefix: str = "") -> dict[str, Any]:
    """{'a/b/0/c': leaf} for a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(flat: dict[str, Any]) -> Any:
    """Inverse of flatten_with_paths: a node whose keys are exactly
    0..n-1 becomes a list."""
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


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = ""
                  ) -> Any:
    """Tree map where fn also receives each leaf's slash-joined path."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def tree_path(attr: str) -> str:
    """'levels.0.gru.gates_x.w' -> 'levels/0/gru/gates_x/w'."""
    return attr.replace(".", "/")


def to_module(tree: Any, buffers: bool = False) -> nn.Module:
    """An nn.Module holding the tree's tensors as parameters (or buffers),
    each at the attribute path of its tree path."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([to_module(v, buffers) for v in tree])
    mod = nn.Module()
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            if buffers:
                mod.register_buffer(k, v)
            else:
                mod.register_parameter(k, nn.Parameter(v))
        else:
            mod.add_module(k, to_module(v, buffers))
    return mod


def from_module(mod: nn.Module, buffers: bool = False) -> Any:
    """The tree to_module was built from (the module's current tensors)."""
    named = mod.named_buffers() if buffers else mod.named_parameters()
    return unflatten({tree_path(k): v for k, v in named})
