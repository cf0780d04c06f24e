"""kernel_work reproduces the bound column of PERF.md's kernel table at
that table's shapes: K1 and K2 over the quickstart G's 15 3x3 adaptive
convs at batch 8, K3/K4 over D's d_step pair and K5 over its R1 pair
(batch 64 at 32², 128 at 16², 8 heads of 64, the null token)."""

import pytest
import torch

from portbench import kernel_work as kw

BF16, F32 = torch.bfloat16, torch.float32


def t(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def g_convs():
    """(h, ci, co) of the quickstart G's 3x3 adaptive convs."""
    dims = [512, 512, 512, 256, 128, 64, 32, 16]
    res = [4, 8, 16, 32, 64, 128, 256]
    out = [(4, 512, 512)]
    for (ci, co), h in zip(zip(dims[:-1], dims[1:]), res):
        out += [(h, ci, co), (h, co, co)]
    return out


def test_k1_k2():
    b = 8
    k1 = k2 = 0.0
    for h, ci, co in g_convs():
        x, w = t(b, h, h, ci, dtype=BF16), t(2, 3, 3, ci, co)
        a, d = t(b, 2), t(b, co)
        k1 += kw.k1_bound((x, w, a, d), t(b, h, h, co, dtype=BF16))[0]
        gout = t(b, h, h, co, dtype=BF16)
        k2 += kw.k2_bound((x, gout, w, a), (t(2, 3, 3, ci, co), t(b, 2)))[0]
    assert len(g_convs()) == 15
    assert round(k1 * 1e3, 3) == 0.089
    assert round(k2 * 1e3, 3) == 0.120


def attn(b, n, heads=8, d=64):
    hd = heads * d
    q, k, v = (t(b, n, hd, dtype=BF16) for _ in range(3))
    bias = t(b, heads, n)
    nk, nv, nb = t(heads, d, dtype=BF16), t(heads, d, dtype=BF16), t(heads)
    return (q, k, v, bias, nk, nv, nb)


def grads(b, n, heads=8, d=64):
    hd = heads * d
    return (t(b, n, hd, dtype=BF16), t(b, n, hd, dtype=BF16),
            t(b, n, hd, dtype=BF16), t(b, heads, n), t(heads, d),
            t(heads, d), t(heads))


PAIR = [(64, 1024), (128, 256)]


@pytest.mark.parametrize("kernel,want", [("k3", 0.180), ("k4", 0.429),
                                         ("k5", 0.946)])
def test_attention(kernel, want):
    total = 0.0
    for b, n in PAIR:
        ops_ = attn(b, n)
        hd = ops_[0].shape[-1]
        g, out, lse = t(b, n, hd, dtype=BF16), t(b, n, hd, dtype=BF16), \
            t(b, 8, n)
        if kernel == "k3":
            total += kw.k3_bound((*ops_, 8), (out, lse))[0]
        elif kernel == "k4":
            total += kw.k4_bound((*ops_, g, out, lse, 8), grads(b, n))[0]
        else:
            cots = grads(b, n)
            outs = (*grads(b, n), t(b, n, hd, dtype=BF16))
            total += kw.k5_bound((*ops_, g, lse, *cots, 8), outs)[0]
    assert round(total * 1e3, 3) == want


def test_bound_names_what_bounds_it():
    assert kw.bound(kw.PEAK_FLOPS, 1.0) == (1.0, "operations")
    assert kw.bound(1.0, kw.PEAK_BYTES * 2) == (2.0, "bytes")
