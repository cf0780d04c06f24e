from gigagan_tpu_torch.utils.helpers import (
    ModTable,
    default,
    exists,
    is_power_of_two,
)
from gigagan_tpu_torch.utils.init import kaiming_normal_leaky_

__all__ = [
    "ModTable",
    "default",
    "exists",
    "is_power_of_two",
    "kaiming_normal_leaky_",
]
