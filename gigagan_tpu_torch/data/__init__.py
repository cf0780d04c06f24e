from gigagan_tpu_torch.data.datasets import (
    DataLoader,
    ImageDataset,
    MockImageDataset,
    SyntheticShapesDataset,
    cycle,
)

__all__ = ["DataLoader", "ImageDataset", "MockImageDataset",
           "SyntheticShapesDataset", "cycle"]
