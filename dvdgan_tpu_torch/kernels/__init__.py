"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (used for CPU tensors and held against the kernel on the card)."""

from dvdgan_tpu_torch.kernels import convgru_blocked, convgru_bwd, convgru_seq
from dvdgan_tpu_torch.kernels.convgru_blocked import gru_sequence_blocked
from dvdgan_tpu_torch.kernels.convgru_seq import gru_sequence_fused

__all__ = ["convgru_blocked", "convgru_bwd", "convgru_seq",
           "gru_sequence_blocked", "gru_sequence_fused"]
