from gigagan_tpu_torch.ops import resample
from gigagan_tpu_torch.ops.adaptive_conv import (
    adaptive_conv,
    adaptive_conv_reference,
    demod_scale,
    expand_batch,
)
from gigagan_tpu_torch.ops.attention import (
    attend,
    attend_fused,
    linear_attend,
    linear_attend_fused,
)
from gigagan_tpu_torch.ops.kernels.demod import kernel_gram
from gigagan_tpu_torch.ops.resample import (
    blur_2d,
    blur_3d,
    blur_temporal,
    downsample_hf_shuttle,
    interpolate_1d,
    pixel_shuffle,
    pixel_shuffle_temporal,
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
    "blur_3d",
    "blur_temporal",
    "demod_scale",
    "downsample_hf_shuttle",
    "expand_batch",
    "interpolate_1d",
    "kernel_gram",
    "linear_attend",
    "linear_attend_fused",
    "pixel_shuffle",
    "pixel_shuffle_temporal",
    "resample",
    "resize_image_to",
    "upsample_2x",
    "upsample_2x_blur",
]
