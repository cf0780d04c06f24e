from gigagan_tpu_torch.utils.helpers import (
    ModTable,
    default,
    exists,
    is_power_of_two,
    num_to_groups,
)
from gigagan_tpu_torch.utils.init import (
    kaiming_normal_leaky_,
    pixel_shuffle_icnr_,
)
from gigagan_tpu_torch.utils.profiling import StepTimer

__all__ = [
    "ModTable",
    "StepTimer",
    "default",
    "exists",
    "is_power_of_two",
    "kaiming_normal_leaky_",
    "num_to_groups",
    "pixel_shuffle_icnr_",
]
