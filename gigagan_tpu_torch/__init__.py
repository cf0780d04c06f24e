"""gigagan_tpu_torch — the PyTorch/CUDA port of ``gigagan_tpu`` for NVIDIA
Hopper.

Module paths mirror the JAX package.  Feature maps are channels-last
``(b, h, w, c)`` at every public function, as in the JAX package.  The
generator's sampling path is ported: its adaptive convs run the
hand-written CUDA kernel K1 and its self-attention the kernel K3
(``ops/kernels``) on the card, and their plain PyTorch versions on the CPU.
"""

__version__ = "0.1.0"

from gigagan_tpu_torch import ops, utils  # noqa: F401
from gigagan_tpu_torch.models import Generator, StyleNetwork  # noqa: F401
from gigagan_tpu_torch.train import GigaGAN  # noqa: F401

__all__ = ["GigaGAN", "Generator", "StyleNetwork", "ops", "utils"]
