from gigagan_tpu_torch.ops import resample
from gigagan_tpu_torch.ops.adaptive_conv import (
    adaptive_conv,
    adaptive_conv_reference,
    demod_scale,
    expand_batch,
    kernel_gram,
)
from gigagan_tpu_torch.ops.attention import attend, attend_fused
from gigagan_tpu_torch.ops.resample import (
    blur_2d,
    pixel_shuffle,
    resize_image_to,
    upsample_2x,
    upsample_2x_blur,
)

__all__ = [
    "adaptive_conv",
    "adaptive_conv_reference",
    "attend",
    "attend_fused",
    "blur_2d",
    "demod_scale",
    "expand_batch",
    "kernel_gram",
    "pixel_shuffle",
    "resample",
    "resize_image_to",
    "upsample_2x",
    "upsample_2x_blur",
]
