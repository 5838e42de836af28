"""Model topologies — the counterpart of `dvdgan_tpu/models/config.py`.

Frozen dataclasses whose derived topology (level count, latent chunking,
channel schedules) is computed once in Python, with the reference's values.
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
# what each level's remat region keeps (`models/generator.py`): the
# reference's DVDGAN_REMAT_SAVE values, default "gru+ups"
REMAT_SAVE_MODES = ("none", "gru", "ups", "gru+ups")

# D width multipliers per input resolution: the channel multiplier after
# each downsampling block, from the from-RGB block's output; the final
# entry is the non-downsampling block.
_D_MULTS = {
    16: (2, 2, 2),
    32: (2, 2, 2, 2),
    64: (1, 2, 4, 8, 16),
    128: (1, 2, 4, 8, 16, 16),
    256: (1, 2, 4, 8, 8, 16, 16),
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
    # route of the levels' upsample conv (`ops/layers.upsample2x_conv3x3`):
    # off | fwd | full. The reference reads it from DVDGAN_UPS_PALLAS.
    ups_fused: str = "off"
    # route of the attention's spatial pass (`ops/attention.spatial_attn`):
    # off | on. The reference reads it from DVDGAN_ATTN_PALLAS.
    attn_fused: str = "off"
    # with remat: what a level keeps instead of recomputing (none | gru |
    # ups | gru+ups). The reference reads it from DVDGAN_REMAT_SAVE.
    remat_save: str = "gru+ups"

    def __post_init__(self):
        if self.remat_save not in REMAT_SAVE_MODES:
            raise ValueError(f"remat_save={self.remat_save!r}: must be one "
                             f"of {REMAT_SAVE_MODES}")

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


@dataclasses.dataclass(frozen=True)
class DSConfig:
    """Spatial discriminator: k random full-resolution frames per clip."""
    img_size: int = 64
    ch: int = 32
    n_classes: int = 101
    k_frames: int = 8

    @property
    def mults(self) -> Tuple[int, ...]:
        return _D_MULTS[self.img_size]

    @property
    def feat_dim(self) -> int:
        return self.ch * self.mults[-1]


@dataclasses.dataclass(frozen=True)
class DTConfig:
    """Temporal discriminator: the whole clip at half spatial resolution;
    the first `n_3d_blocks` residual blocks are 3-D convs."""
    img_size: int = 64            # full-res; DT consumes img_size // 2
    n_frames: int = 8
    ch: int = 32
    n_classes: int = 101
    n_3d_blocks: int = 2

    @property
    def input_size(self) -> int:
        return self.img_size // 2

    @property
    def mults(self) -> Tuple[int, ...]:
        return _D_MULTS[self.input_size]

    @property
    def feat_dim(self) -> int:
        return self.ch * self.mults[-1]
