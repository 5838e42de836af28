"""Generator topology — the counterpart of `dvdgan_tpu/models/config.py`.

A frozen dataclass whose derived topology (level count, latent chunking,
channel schedule) is computed once in Python, with the reference's values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# G width multipliers per output resolution, one entry per feature
# resolution 4, 8, ..., S; level i maps mults[i] -> mults[i + 1].
_G_MULTS = {
    32: (4, 4, 4, 4),
    64: (8, 8, 4, 2, 1),
    128: (16, 16, 8, 4, 2, 1),
    256: (16, 16, 8, 8, 4, 2, 1),
}


@dataclasses.dataclass(frozen=True)
class GConfig:
    """Generator topology."""
    img_size: int = 64
    n_frames: int = 8            # GENERATED frames per clip
    ch: int = 32                 # base width unit
    z_dim: int = 120
    n_classes: int = 101
    emb_dim: int = 120           # shared class-embedding width
    attn_res: Optional[int] = 32  # separable attention at this resolution
    base_res: int = 4
    remat: bool = False
    cond_frames: int = 0         # DVD-GAN-FP prefix length; 0 = synthesis

    @property
    def mults(self) -> Tuple[int, ...]:
        return _G_MULTS[self.img_size]

    @property
    def n_levels(self) -> int:
        """Upsampling levels: 4 -> img_size."""
        return int(math.log2(self.img_size // self.base_res))

    @property
    def chunk_dim(self) -> int:
        """z splits into n_levels + 1 equal chunks: one seeds the 4×4 map,
        one conditions each level's CBNs."""
        n = self.n_levels + 1
        if self.z_dim % n:
            raise ValueError(f"z_dim={self.z_dim} not divisible by {n} chunks")
        return self.z_dim // n

    @property
    def cond_dim(self) -> int:
        return self.chunk_dim + self.emb_dim

    def level_channels(self, i: int) -> Tuple[int, int]:
        m = self.mults
        return self.ch * m[i], self.ch * m[i + 1]
