from gigagan_tpu_torch.train.trainer import GigaGAN

__all__ = ["GigaGAN"]
