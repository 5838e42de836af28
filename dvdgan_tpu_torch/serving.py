"""The serving artifact — the counterpart of `tools/export_serving.py`
(`export_sampler`) and of `jax.export.deserialize` on what it writes.

`export_sampler` traces EMA-G's sampling (`train/step.py:sample`:
eval-mode BN, SN with frozen u) with `torch.export` into one program,
which `torch.export.save` writes and which runs without this package's
model code:

    from dvdgan_tpu_torch.serving import load_sampler
    serve = load_sampler("g_sampler.pt2")
    clips = serve(z, y)      # z (B, z_dim) f32, y (B,) int64 on the
    #                          artifact's device -> (B, T, H, W, 3) f32
    # DVD-GAN-FP artifacts also take cond (B, cond_frames, H, W, 3) f32

The SN pass runs once, at export: its normalized EMA weights and G's BN
running statistics are baked into the artifact, so a call runs G's
forward alone (`step.sample` runs the SN pass on every call). With
`dtype="bfloat16"` the weights are baked in bf16 and the BN statistics
stay f32, as the reference bakes them; the interface is f32 in and out
either way (the cast is inside). The weights are those `step.sample`
computes from the f32 EMA weights, so an artifact's clip has the bits of
`step.sample` on the same device and inputs.

The kernels go into the artifact as the registered ops of
`kernels/library.py` (K1 and K3 at every GRU level, K5a with
`ups_fused != "off"`, K6a/K6b with `attn_fused == "on"`), which
`load_sampler` registers by importing that module. An artifact is
specific to the device it was exported on: on the card its ops launch
the kernels, on the CPU they run the plain versions.
"""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _Sampler(torch.nn.Module):
    """G's eval-mode forward over baked trees (buffers), f32 in and out."""

    def __init__(self, params: dict, stats: dict, g_cfg, dtype: torch.dtype):
        from dvdgan_tpu_torch.core import tree as tru
        super().__init__()
        self.params = tru.to_module(params, buffers=True)
        self.stats = tru.to_module(stats, buffers=True)
        self.g_cfg, self.dtype = g_cfg, dtype

    def sample(self, z, y, cond=None):
        from dvdgan_tpu_torch.core import tree as tru
        from dvdgan_tpu_torch.models import generator
        if cond is not None:
            cond = cond.to(self.dtype)
        video, _ = generator.apply(
            tru.from_module(self.params, buffers=True),
            tru.from_module(self.stats, buffers=True), z.to(self.dtype), y,
            self.g_cfg, train=False, cond_video=cond)
        return video.float()

    def forward(self, z, y):
        return self.sample(z, y)


class _FPSampler(_Sampler):
    """DVD-GAN-FP: also the real prefix `cond`."""

    def forward(self, z, y, cond):
        return self.sample(z, y, cond)


@torch.no_grad()
def export_sampler(state, g_cfg, batch: int, device, dtype: str = "float32"
                   ) -> torch.export.ExportedProgram:
    """The EMA-G sampler of `state` (a `GeneratorState`: EMA params, BN
    stats, SN u) for `g_cfg` on `device`, as a `torch.export` program
    taking (z, y) or, for FP, (z, y, cond). `batch` clips a call; 0 gives
    one batch-polymorphic program (any batch ≥ 1). `dtype`: "float32" or
    "bfloat16", the weights' and the computation's type."""
    from dvdgan_tpu_torch.core import tree as tru
    from dvdgan_tpu_torch.ops import spectral_norm as sn

    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                         f"{dtype!r}")
    if batch < 0:
        raise ValueError(f"batch must be ≥ 0 (0: polymorphic), got {batch}")
    compute, device = DTYPES[dtype], torch.device(device)
    params, stats, sn_u = (tru.tree_map(lambda v: v.detach().to(device), t)
                           for t in state.trees())
    params_sn, _ = sn.sn_normalize(params, sn_u, update=False,
                                   compute_dtype=compute)
    fp = g_cfg.cond_frames > 0
    module = (_FPSampler if fp else _Sampler)(params_sn, stats, g_cfg,
                                              compute)
    b = batch or 2
    f32 = dict(dtype=torch.float32, device=device)
    args = [torch.zeros((b, g_cfg.z_dim), **f32),
            torch.zeros((b,), dtype=torch.long, device=device)]
    if fp:
        args.append(torch.zeros((b, g_cfg.cond_frames, g_cfg.img_size,
                                 g_cfg.img_size, 3), **f32))
    dynamic = None
    if batch == 0:
        dim = torch.export.Dim("batch", min=1)
        dynamic = tuple({0: dim} for _ in args)
    return torch.export.export(module, tuple(args), dynamic_shapes=dynamic)


def load_sampler(path: str):
    """The artifact at `path` as a callable (z, y[, cond]) -> clips. Needs
    `torch` and the registered ops of `kernels/library.py` alone."""
    from dvdgan_tpu_torch.kernels import library  # noqa: F401  (the ops)
    return torch.export.load(path).module()


def op_counts(program: torch.export.ExportedProgram) -> dict[str, int]:
    """{op name: nodes} of the `dvdgan::` ops in the program's graph."""
    counts: dict[str, int] = {}
    for node in program.graph.nodes:
        target = node.target
        if node.op == "call_function" and getattr(
                target, "namespace", None) == "dvdgan":
            name = target.name()
            counts[name] = counts.get(name, 0) + 1
    return counts
