from gigagan_tpu_torch.data.datasets import (
    DataLoader,
    MockImageDataset,
    cycle,
)

__all__ = ["DataLoader", "MockImageDataset", "cycle"]
