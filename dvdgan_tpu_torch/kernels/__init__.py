"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (used for CPU tensors and held against the kernel on the card).
The counterpart of `dvdgan_tpu/kernels/__init__.py`: K1 `gru_sequence_fused`
(`convgru_seq`), K2 `convgru_bwd.gru_sequence_bwd`, K3 `gru_sequence_blocked`
(`convgru_blocked`), K4 `gru_cell_fused` (`convgru_cell`), K5a/K5b
`ups2x_fused.ups2x` and `ups2x_fused.ups2x_bwd`, K6a/K6b
`spatial_attn_fused` and `spatial_attn_tiled` (`attention_spatial`).
`library` registers the forwards that sampling reaches as `dvdgan::` ops,
which the entries call while `torch.export` traces them."""

from dvdgan_tpu_torch.kernels import (attention_spatial, convgru_blocked,
                                      convgru_bwd, convgru_cell, convgru_seq,
                                      library, ups2x_fused)
from dvdgan_tpu_torch.kernels.attention_spatial import (spatial_attn_fused,
                                                        spatial_attn_tiled)
from dvdgan_tpu_torch.kernels.convgru_blocked import gru_sequence_blocked
from dvdgan_tpu_torch.kernels.convgru_cell import gru_cell_fused
from dvdgan_tpu_torch.kernels.convgru_seq import gru_sequence_fused

__all__ = ["attention_spatial", "convgru_blocked", "convgru_bwd",
           "convgru_cell", "convgru_seq", "library", "ups2x_fused",
           "gru_cell_fused", "gru_sequence_blocked", "gru_sequence_fused",
           "spatial_attn_fused", "spatial_attn_tiled"]
