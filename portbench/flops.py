"""Operation counts of the reference's work: every matrix product,
convolution (forward and backward, to any order) and attention call that
runs inside the mode, by ``torch.utils.flop_counter``'s formulas; no
elementwise op.  (``FlopCounterMode`` itself also tracks modules, which
refuses a module input that requires a gradient under ``no_grad``.)"""

from __future__ import annotations

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


class CountFlops(TorchDispatchMode):
    """``with CountFlops() as c: ...``; then ``c.total``."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.total += count(*args, **kwargs, out_val=out)
        return out
