from dvdgan_tpu_torch.models.config import GConfig

__all__ = ["GConfig"]
