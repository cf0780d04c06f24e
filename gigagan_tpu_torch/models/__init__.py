from gigagan_tpu_torch.models import layers
from gigagan_tpu_torch.models.conditioning import StyleNetwork
from gigagan_tpu_torch.models.discriminator import Discriminator
from gigagan_tpu_torch.models.generator import Generator

__all__ = ["Discriminator", "Generator", "StyleNetwork", "layers"]
