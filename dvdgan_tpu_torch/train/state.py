"""Train state — the counterpart of `dvdgan_tpu/train/state.py`.

The state is one tree of the reference's layout, so a step is a function
`(state, batch, draws) -> (state, metrics)` and `interop` carries it across
leaf by leaf:

    step                      int32 scalar
    g   {params, stats, sn_u, opt}
    ds  {params, sn_u, opt}
    dt  {params, sn_u, opt}
    g_ema                     G's params, averaged

`sn_u` trees are {path: u} as `ops.spectral_norm` keeps them; `opt` is
optax's Adam state {count, mu, nu}. Adam is written here as a functional
update on those trees (optax.adam(lr, b1, b2, eps=1e-8): bias-corrected,
eps outside the square root), not `torch.optim.Adam`, whose state lives
inside objects and which updates in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from dvdgan_tpu_torch.core.tree import tree_map
from dvdgan_tpu_torch.models import DSConfig, DTConfig, GConfig
from dvdgan_tpu_torch.models import discriminator, generator
from dvdgan_tpu_torch.ops import spectral_norm as sn

ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The alternating hinge-loss loop: Adam β=(0, 0.999), lr 1e-4 (G) /
    5e-4 (D), d_steps D updates per G update, EMA decay 0.9999 after
    ema_start steps of copy-through."""
    lr_g: float = 1e-4
    lr_d: float = 5e-4
    beta1: float = 0.0
    beta2: float = 0.999
    d_steps: int = 2
    ema_decay: float = 0.9999
    ema_start: int = 1000
    grad_accum: int = 1           # micro-batches per optimizer update
    fake_gen: str = "pooled"      # pooled | per_step (train/step.py)
    log_grad_norms: bool = False  # d_grad_norm, g_grad_norm in the metrics


def to_device(state: Any, device: torch.device) -> Any:
    """The state tree with every tensor on `device`."""
    return tree_map(lambda v: v.to(device), state)


def adam_init(params: Any) -> dict:
    return {"count": torch.zeros((), dtype=torch.int32),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params)}


def adam_update(grads: Any, opt: dict, params: Any, lr: float, b1: float,
                b2: float) -> tuple[Any, dict]:
    """(new params, new opt): optax.scale_by_adam then scale(-lr), applied.
    mu = (1−b1)·g + b1·mu; nu = (1−b2)·g² + b2·nu; the update is
    −lr · (mu / (1 − b1^n)) / (√(nu / (1 − b2^n)) + eps) at count n."""
    count = opt["count"] + 1
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, opt["mu"])
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, opt["nu"])
    n = count.float()
    # torch.full fills on the device; torch.tensor(b, device=cuda) would be
    # a host-to-device copy that waits for the stream
    bc1 = 1 - torch.full((), b1, dtype=torch.float32, device=n.device) ** n
    bc2 = 1 - torch.full((), b2, dtype=torch.float32, device=n.device) ** n
    new_params = tree_map(
        lambda p, m, v: p + (-lr) * ((m / bc1) / (torch.sqrt(v / bc2)
                                                  + ADAM_EPS)),
        params, mu, nu)
    return new_params, {"count": count, "mu": mu, "nu": nu}


def create(seed: int, g_cfg: GConfig, ds_cfg: DSConfig, dt_cfg: DTConfig
           ) -> dict[str, Any]:
    """The initial train state on the CPU, drawn from one torch.Generator
    seeded with `seed` (the draws differ from jax.random's)."""
    gen = torch.Generator().manual_seed(seed)
    g_params, g_stats = generator.init(gen, g_cfg)
    ds_params = discriminator.ds_init(gen, ds_cfg)
    dt_params = discriminator.dt_init(gen, dt_cfg)
    return {
        "step": torch.zeros((), dtype=torch.int32),
        "g": {"params": g_params, "stats": g_stats,
              "sn_u": sn.sn_init(gen, g_params), "opt": adam_init(g_params)},
        "ds": {"params": ds_params, "sn_u": sn.sn_init(gen, ds_params),
               "opt": adam_init(ds_params)},
        "dt": {"params": dt_params, "sn_u": sn.sn_init(gen, dt_params),
               "opt": adam_init(dt_params)},
        "g_ema": tree_map(torch.clone, g_params),
    }


def ema_update(ema: Any, params: Any, decay: float, step: torch.Tensor,
               start: int) -> Any:
    """Copy-through before `start` steps, then exponential decay."""
    d = decay * (step >= start).float()
    return tree_map(lambda e, p: d * e + (1.0 - d) * p, ema, params)
