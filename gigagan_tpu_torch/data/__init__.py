from gigagan_tpu_torch.data.datasets import (
    DataLoader,
    ImageDataset,
    MockImageDataset,
    MockTextImageDataset,
    SyntheticShapesDataset,
    TextImageDataset,
    collate_tensors_or_str,
    cycle,
)

__all__ = ["DataLoader", "ImageDataset", "MockImageDataset",
           "MockTextImageDataset", "SyntheticShapesDataset",
           "TextImageDataset", "collate_tensors_or_str", "cycle"]
