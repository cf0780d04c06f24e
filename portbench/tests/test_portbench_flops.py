"""The operation count behind mfu.*, against hand counts."""

import torch
import torch.nn.functional as F

from portbench.flops import CountFlops
from portbench.reference import ops


def test_conv_forward_and_backward():
    x = torch.randn(2, 8, 16, 16, requires_grad=True)
    w = torch.randn(4, 8, 3, 3, requires_grad=True)
    with CountFlops() as c:
        F.conv2d(x, w, padding=1).sum().backward()
    fwd = 2 * 2 * 16 * 16 * 3 * 3 * 8 * 4
    assert c.total == 3 * fwd  # forward, input and weight gradients


def test_attention():
    b, h, n, m, d = 2, 3, 10, 12, 8
    q, k, v = torch.randn(b, h, n, d), torch.randn(b, h, m, d), \
        torch.randn(b, h, m, d)
    with CountFlops() as c:
        ops.attend(q, k, v)
    assert c.total == 2 * (2 * b * h * n * m * d)
