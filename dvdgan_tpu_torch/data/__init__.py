"""Input pipeline of the port: synthetic clips and the prefetching loader
(numpy only). The frame-folder dataset is not ported yet."""

from dvdgan_tpu_torch.data.loader import Loader  # noqa: F401
from dvdgan_tpu_torch.data.synthetic import SyntheticVideoDataset  # noqa: F401
