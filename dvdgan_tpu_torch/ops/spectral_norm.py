"""Spectral normalization as a pass over a parameter tree — the counterpart
of `dvdgan_tpu/ops/spectral_norm.py`.

Every leaf named `w` (conv/linear kernels) or `emb` (class embeddings) is
divided by a power-iteration estimate of its top singular value. The kernel
is viewed as (in_flat, out) and the persistent `u` lives in the out space.
One power iteration runs on every call, also with `update=False`: σ then
comes from the advanced u, but the stored u is echoed back unchanged. (So
`torch.nn.utils.spectral_norm`, which does no iteration in eval mode, is
not this contract.) All σ math is float32; with `compute_dtype` every leaf
of the normalized tree comes out in that dtype.
"""

from __future__ import annotations

import torch

from dvdgan_tpu_torch.core import tree as tru
from dvdgan_tpu_torch.utils.profiling import span

_EPS = 1e-12
_SN_LEAF_NAMES = ("w", "emb")


def _is_sn_leaf(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in _SN_LEAF_NAMES


def _as_matrix(w: torch.Tensor) -> torch.Tensor:
    """(in_flat, out): HWIO folds receptive field and input channels."""
    return w.reshape(-1, w.shape[-1])


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + _EPS)


def sn_init(gen: torch.Generator, params) -> dict[str, torch.Tensor]:
    """{path: u} for every `w`/`emb` leaf, u ~ N(0, 1) normalized, drawn
    in sorted path order."""
    flat = tru.flatten_with_paths(params)
    u = {}
    for p in sorted(p for p in flat if _is_sn_leaf(p)):
        u[p] = _l2norm(torch.randn(flat[p].shape[-1], generator=gen))
    return u


def _power_iteration(w_mat: torch.Tensor, u: torch.Tensor, n_iter: int):
    """n_iter power-iteration steps on a detached W; returns (u', v)."""
    w_sg = w_mat.detach()
    for _ in range(n_iter):
        v = _l2norm(w_sg @ u)             # (in_flat,)
        u = _l2norm(w_sg.T @ v)           # (out,)
    v = _l2norm(w_sg @ u)
    return u.detach(), v.detach()


def sigma_and_update(w: torch.Tensor, u: torch.Tensor, n_iter: int = 1):
    """(σ, u_next). σ = vᵀ W u with u, v held constant, so ∂σ/∂W = v uᵀ."""
    w_mat = _as_matrix(w.float())
    u_next, v = _power_iteration(w_mat, u.float(), n_iter)
    sigma = v @ (w_mat @ u_next)
    return sigma, u_next


def sn_sigmas(params, sn_u: dict[str, torch.Tensor]
              ) -> dict[str, torch.Tensor]:
    """{path: σ estimate} of every normalized kernel from the stored u,
    which is not advanced (the trainer's `--log_sigmas` telemetry)."""
    flat = tru.flatten_with_paths(params)
    return {p: sigma_and_update(flat[p], u)[0] for p, u in sn_u.items()}


def sn_normalize(params, sn_u: dict[str, torch.Tensor], update: bool,
                 n_iter: int = 1, compute_dtype=None):
    """(params with matching kernels divided by σ, new {path: u}).

    `update` selects whether the returned u advances (the owning model's
    train step) or echoes the input (sampling, the non-updating phase).
    The pass is the span "sn"."""
    new_u: dict[str, torch.Tensor] = {}

    def norm_leaf(path: str, w):
        if path not in sn_u:
            return w.to(compute_dtype) if compute_dtype is not None else w
        sigma, u_next = sigma_and_update(w, sn_u[path], n_iter)
        new_u[path] = u_next if update else sn_u[path]
        w_sn = w.float() / sigma
        return w_sn.to(compute_dtype if compute_dtype is not None else w.dtype)

    with span("sn"):
        params_sn = tru.map_with_path(norm_leaf, params)
    return params_sn, new_u
