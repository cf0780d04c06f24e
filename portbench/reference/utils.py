"""Small pure-python helpers (a copy of gigagan_tpu_torch/utils/helpers.py)."""

from __future__ import annotations

from math import log2
from typing import Sequence


def exists(val):
    return val is not None


def default(*vals):
    for val in vals:
        if exists(val):
            return val
    return None


def is_power_of_two(n) -> bool:
    return log2(n).is_integer()



class ModTable:
    """Indexed access into the style→modulation projection.

    The generator projects the style vector ONCE to every layer's
    modulation and kernel-selection vector; layers consume the slices in
    order and the forward asserts that every slice was consumed.
    """

    def __init__(self, mods, split_dims: Sequence[int]):
        # mods: (batch, sum(split_dims)) tensor
        assert mods.shape[-1] == sum(split_dims), (
            f"modulation vector has dim {mods.shape[-1]} but layers expect "
            f"{sum(split_dims)}"
        )
        self._entries = []
        offset = 0
        for dim in split_dims:
            self._entries.append(mods[..., offset : offset + dim])
            offset += dim
        self._cursor = 0

    def next(self):
        assert self._cursor < len(self._entries), "modulation table exhausted"
        entry = self._entries[self._cursor]
        self._cursor += 1
        # zero-width entries stand in for "no kernel selection" slots
        return entry if entry.shape[-1] > 0 else None

    def skip(self, n: int):
        """Pass over ``n`` slots (an image through a video-capable net skips
        its temporal blocks' modulations)."""
        self._cursor += n
        assert self._cursor <= len(self._entries)

    def assert_exhausted(self):
        assert self._cursor == len(self._entries), (
            f"convolutions were incorrectly modulated: consumed "
            f"{self._cursor}/{len(self._entries)} modulation slots"
        )
