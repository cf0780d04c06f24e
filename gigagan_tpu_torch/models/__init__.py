from gigagan_tpu_torch.models import layers
from gigagan_tpu_torch.models.clip import OpenClipAdapter
from gigagan_tpu_torch.models.conditioning import StyleNetwork, TextEncoder
from gigagan_tpu_torch.models.discriminator import Discriminator
from gigagan_tpu_torch.models.generator import Generator
from gigagan_tpu_torch.models.unet_upsampler import UnetUpsampler
from gigagan_tpu_torch.models.vision_aided import VisionAidedDiscriminator

__all__ = ["Discriminator", "Generator", "OpenClipAdapter", "StyleNetwork",
           "TextEncoder", "UnetUpsampler", "VisionAidedDiscriminator",
           "layers"]
