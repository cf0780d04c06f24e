from gigagan_tpu_torch.utils.helpers import (
    ModTable,
    default,
    exists,
    is_power_of_two,
    num_to_groups,
)
from gigagan_tpu_torch.utils.init import (
    dirac_1d_,
    kaiming_normal_leaky_,
    pixel_shuffle_icnr_,
)
from gigagan_tpu_torch.utils.profiling import SPANS, StepTimer, span

__all__ = [
    "ModTable",
    "SPANS",
    "StepTimer",
    "default",
    "dirac_1d_",
    "exists",
    "is_power_of_two",
    "kaiming_normal_leaky_",
    "num_to_groups",
    "pixel_shuffle_icnr_",
    "span",
]
