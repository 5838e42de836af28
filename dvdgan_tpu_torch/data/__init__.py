"""Input pipeline of the port: synthetic clips, frame folders and the
prefetching loader (numpy, the port's native clip ops, PIL where present)."""

from dvdgan_tpu_torch.data.frames import FrameFolderDataset  # noqa: F401
from dvdgan_tpu_torch.data.loader import Loader  # noqa: F401
from dvdgan_tpu_torch.data.synthetic import SyntheticVideoDataset  # noqa: F401
