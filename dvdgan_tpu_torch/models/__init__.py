from dvdgan_tpu_torch.models.config import DSConfig, DTConfig, GConfig

__all__ = ["DSConfig", "DTConfig", "GConfig"]
