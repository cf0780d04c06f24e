"""gigagan_tpu_torch — the PyTorch/CUDA port of ``gigagan_tpu`` for NVIDIA
Hopper.

Module paths mirror the JAX package.  Feature maps are channels-last
``(b, h, w, c)`` at every public function, as in the JAX package.  Ported:
the generator's sampling path, the G+D training steps and trainer, the
text-conditioned path (CLIP and its adapter, the text encoders,
cross-attention, the conditional discriminator, the vision-aided
discriminator, the matching-aware and contrastive losses), and the UNet
upsampler (image and video) with its trainer.
On the card the adaptive convs run the hand-written CUDA kernels K1
(forward and input gradient) and K2 (weight gradient), and the fused-heads
self-attention K3 (forward), K4 (backward) and K5 (its adjoint, in the R1
penalty's double backward), all through autograd Functions
(``ops/kernels``); on the CPU the same Functions run the kernels' plain
PyTorch versions.
"""

__version__ = "0.1.0"

from gigagan_tpu_torch import ops, utils  # noqa: F401
from gigagan_tpu_torch.data import MockTextImageDataset  # noqa: F401
from gigagan_tpu_torch.models import (  # noqa: F401
    Discriminator,
    Generator,
    OpenClipAdapter,
    StyleNetwork,
    TextEncoder,
    UnetUpsampler,
    VisionAidedDiscriminator,
)
from gigagan_tpu_torch.train import GigaGAN  # noqa: F401

__all__ = ["Discriminator", "GigaGAN", "Generator", "MockTextImageDataset",
           "OpenClipAdapter", "StyleNetwork", "TextEncoder",
           "UnetUpsampler", "VisionAidedDiscriminator", "ops", "utils"]
