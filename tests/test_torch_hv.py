"""The split-heads flash attention (K6a/K6b) and its grad-of-jvp pair
(K7a/K7b) of the PyTorch port against the JAX package on the CPU: the
plain versions against the Pallas kernels in interpret mode
(``flash_attend``, and ``flash_attend_hv``'s jvp pair ``_jvp_impl`` /
``_pair_bwd``), the tangents forward AD gives the prep against
``prep_tangents``, a float64 grad-of-jvp check of ``_FlashAttendHV`` through
the network's null-token route, and the dispatch of ``attend`` /
``attend_fused`` in and out of ``flash_hv_mode``.  Inputs come from numpy
with a fixed seed; both sides get the same arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu.ops.pallas.flash_attention import (  # noqa: E402
    _flash_fwd_impl as jax_flash_fwd,
    flash_attend as jax_flash_attend,
)
from gigagan_tpu.ops.pallas.flash_attention_hv import (  # noqa: E402
    _jvp_impl as jax_jvp_impl,
    _pair_bwd as jax_pair_bwd,
    _prep_tangents as jax_prep_tangents,
    flash_attend_hv as jax_flash_attend_hv,
)

from gigagan_tpu_torch.ops.attention import attend, attend_fused  # noqa: E402
from gigagan_tpu_torch.ops.kernels import plain_reference  # noqa: E402
from gigagan_tpu_torch.ops.kernels import (  # noqa: E402
    flash_attention as k6,
    flash_attention_fused as k3,
    flash_attention_hv as k7,
)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_max(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def qkv(seed, b=2, h=2, nq=9, nk=11, d=16, tangents=False):
    rng = np.random.default_rng(seed)
    shapes = [(b, h, nq, d), (b, h, nk, d), (b, h, nk, d)]
    if tangents:
        shapes += shapes
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def key_mask(seed, b, nk):
    mask = np.random.default_rng(seed).random((b, nk)) > 0.3
    mask[:, 0] = True
    return mask


CASES = [(l2, masked) for l2 in (False, True) for masked in (False, True)]
IDS = [f"{'l2' if l2 else 'dot'}-{'mask' if m else 'no_mask'}"
       for l2, m in CASES]


# ------------------------------------------------------------ K6a / K6b

@pytest.mark.parametrize(
    "l2,masked", CASES + [(True, "shared"), (False, "all"), (True, "all")],
    ids=IDS + ["l2-shared_qk", "dot-all_masked", "l2-all_masked"])
def test_k6_plain_matches_pallas_flash_attend(l2, masked):
    # "all": sample 0 has every key masked.  NEG_INF stays finite: its rows
    # take the mean of v and lse = NEG_INF, and the backward P = 1 at every
    # key.  nk = 128 because the Pallas prep pads the keys to 128 lanes with
    # NEG_INF bias, and an all-masked row's mean would take in the padding.
    shared = masked == "shared"
    all_masked = masked == "all"
    nk = 9 if shared else 128 if all_masked else 11
    q, k, v = qkv(40, nk=nk)
    if shared:
        k = q
    mask = key_mask(41, 2, nk) if masked in (True, "all") else None
    if all_masked:
        mask[0] = False
    jmask = None if mask is None else jnp.asarray(mask)
    rng = np.random.default_rng(42)
    w = rng.standard_normal(q.shape).astype(np.float32)

    def loss_j(q_, k_, v_):
        if shared:
            k_ = q_
        return jnp.sum(jax_flash_attend(q_, k_, v_, jmask, l2, None, True)
                       * w)

    out_j, _, lse_j = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jmask, l2, None, True)
    grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    qt, kt, vt = (t(a).requires_grad_() for a in (q, k, v))
    tmask = None if mask is None else t(mask)
    out = k7.flash_attend_hv(qt, qt if shared else kt, vt, tmask, l2)
    (out * t(w)).sum().backward()
    assert torch.isfinite(out).all()
    assert rel_max(out.detach().numpy(), out_j) <= 2e-4

    # K6a's plain version on the prepared operands: lse too
    ops = k6.prep_split(t(q), t(k), t(v), tmask, l2, 16 ** -0.5)
    _, lse = k6.flash_attention_fwd(*ops)
    lse_j = np.asarray(lse_j)[:, 0, :9]
    if all_masked:  # sample 0's rows (its two heads) hold NEG_INF exactly
        assert (lse[:2] == np.float32(k6.NEG_INF)).all()
        np.testing.assert_array_equal(lse[:2].numpy(), lse_j[:2])
        np.testing.assert_allclose(out[0].detach().numpy(),
                                   np.broadcast_to(v[0].mean(1, keepdims=True),
                                                   out[0].shape), rtol=1e-5,
                                   atol=1e-6)
        lse, lse_j = lse[2:], lse_j[2:]
    assert rel_max(lse.numpy(), lse_j) <= 2e-4

    names = ("dq", "dk", "dv")
    got = (qt.grad, None if shared else kt.grad, vt.grad)
    for name, g, w_ in zip(names, got, grads_j):
        if g is None:
            continue
        assert torch.isfinite(g).all(), name
        if all_masked and l2 and name == "dk":
            # the Pallas backward folds the |k|² chain rule in without the
            # mask (dk = coeff·dSᵀq − colsum(dS)·k), which differs from the
            # true derivative only where dS ≠ 0 at masked keys: in the
            # all-masked sample 0
            g, w_ = g[1:], np.asarray(w_)[1:]
        assert rel_max(g.numpy(), w_) <= 2e-4, name


# ------------------------------------------------------------ K7a / K7b

@pytest.mark.parametrize("l2,masked", CASES, ids=IDS)
def test_prep_forward_ad_matches_prep_tangents(l2, masked):
    # the R1 surrogate takes the tangents of k̂ and the bias from forward
    # AD of prep_split; they must be prep_tangents' (and the Pallas
    # _prep_tangents') t̂k and tbias, zero under the mask
    q, k, v, tq, tk, tv = qkv(54, tangents=True)
    mask = key_mask(55, 2, 11) if masked else None
    tmask = None if mask is None else t(mask)
    scale = 16 ** -0.5
    _, tangents = torch.func.jvp(
        lambda a, b_, c: k6.prep_split(a, b_, c, tmask, l2, scale),
        (t(q), t(k), t(v)), (t(tq), t(tk), t(tv)))
    _, tk_ad, _, tbias_ad = tangents
    tq_pre, tk_pre, tbias = k7.prep_tangents(t(q), t(k), t(tq), t(tk),
                                             tmask, l2, scale)
    torch.testing.assert_close(tangents[0], tq_pre, rtol=0, atol=0)
    torch.testing.assert_close(tk_ad, tk_pre, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(tbias_ad, tbias, rtol=1e-6, atol=1e-6)
    want = jax_prep_tangents(
        *(jnp.asarray(a) for a in (q, k, tq, tk)),
        None if mask is None else jnp.asarray(mask), l2, scale)
    assert rel_max(tk_pre.numpy(), want[1]) <= 1e-6
    assert rel_max(tbias.numpy(), np.asarray(want[2])[:, 0]) <= 1e-6


@pytest.mark.parametrize("l2,masked", CASES, ids=IDS)
def test_k7_plain_matches_pallas_jvp_pair(l2, masked):
    # the sizes of tests/test_pallas.py's grad-of-jvp check, which runs the
    # same interpret-mode kernels
    b, h, n, nk, d = 2, 2, 32, 33, 16
    q, k, v, tq, tk, tv = qkv(43, b, h, n, nk, d, tangents=True)
    mask = key_mask(44, b, nk) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else t(mask)
    scale = d ** -0.5
    rng = np.random.default_rng(45)
    go, gt = (rng.standard_normal(q.shape).astype(np.float32)
              for _ in range(2))
    jin = [jnp.asarray(a) for a in (q, k, v, tq, tk, tv)]

    # K7a on the prepared operands and their tangents
    out_j, tout_j, lse_j = jax_jvp_impl(*jin, jmask, l2, scale, True)
    ins = [t(a).requires_grad_() for a in (q, k, v, tq, tk, tv)]
    qf, k_pre, vf, bias = k6.prep_split(*ins[:3], tmask, l2, scale)
    tqf, tk_pre, tbias = k7.prep_tangents(ins[0], ins[1], ins[3], ins[4],
                                          tmask, l2, scale)
    tvf = ins[5].reshape(b * h, nk, d)
    out, tout = k7._AttendJvpPair.apply(qf, k_pre, vf, bias, tqf, tk_pre,
                                        tvf, tbias)[:2]
    shape = (b, h, n, d)
    assert rel_max(out.detach().reshape(shape).numpy(), out_j) <= 1e-5
    assert rel_max(tout.detach().reshape(shape).numpy(), tout_j) <= 1e-5
    lse = k7.flash_attention_hv_jvp(qf.detach(), k_pre.detach(), vf,
                                    bias.detach(), tqf, tk_pre.detach(), tvf,
                                    tbias.detach())[2]
    assert rel_max(lse.numpy(), np.asarray(lse_j)[:, 0, :n]) <= 1e-5

    # K7b: the pair's backward, with the chain rule back to the raw
    # operands through autograd of the preps, against _pair_bwd
    want = jax_pair_bwd(l2, scale, True, (*jin, jmask, lse_j),
                        (jnp.asarray(go), jnp.asarray(gt)))
    torch.autograd.backward(
        [out, tout], [t(go).reshape(out.shape), t(gt).reshape(out.shape)])
    for name, a, w_ in zip(("q", "k", "v", "tq", "tk", "tv"), ins, want):
        assert rel_max(a.grad.numpy(), w_) <= 1e-5, name


@pytest.mark.parametrize("l2", [False, True], ids=["dot", "l2"])
def test_grad_of_jvp_matches_pallas(l2):
    # the forward-over-reverse structure: jvp, then the gradient of a
    # function of (out, tout) — K6a, K7a, and K6b/K7b in the reverse pass
    b, h, n, nk, d = 2, 2, 32, 33, 16
    q, k, v, tq, tk, tv = qkv(46, b, h, n, nk, d, tangents=True)

    def s_j(q_, k_, v_):
        out, tout = jax.jvp(
            lambda a, b_, c: jax_flash_attend_hv(a, b_, c, None, l2, None,
                                                 True),
            (q_, k_, v_), tuple(jnp.asarray(x) for x in (tq, tk, tv)))
        return jnp.sum(tout ** 2) + jnp.sum(out ** 3)

    want = jax.grad(s_j, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    ins = [t(a).requires_grad_() for a in (q, k, v)]
    out, tout = torch.func.jvp(
        lambda a, b_, c: k7.flash_attend_hv(a, b_, c, None, l2), tuple(ins),
        tuple(t(x) for x in (tq, tk, tv)))
    got = torch.autograd.grad((tout ** 2).sum() + (out ** 3).sum(), ins)
    for name, g, w_ in zip("qkv", got, want):
        assert rel_max(g.numpy(), w_) <= 1e-5, name


def reference_attention(q, k, v, heads, null_kv, l2):
    """Softmax attention in the fused-heads layout, written out: the null
    token concatenated, the full L2 distance −scale·|q − k|² (or
    scale·q·k)."""
    b, n, hd = q.shape
    d = hd // heads
    qh, kh, vh = (x.reshape(b, -1, heads, d).transpose(1, 2)
                  for x in (q, k, v))
    kh = torch.cat((null_kv[0][None, :, None].expand(b, heads, 1, d), kh), 2)
    vh = torch.cat((null_kv[1][None, :, None].expand(b, heads, 1, d), vh), 2)
    if l2:
        sim = -(d ** -0.5) * ((qh[..., :, None, :] - kh[..., None, :, :])
                              ** 2).sum(-1)
    else:
        sim = (d ** -0.5) * qh @ kh.transpose(-1, -2)
    out = torch.softmax(sim, -1) @ vh
    return out.transpose(1, 2).reshape(b, n, hd)


@pytest.mark.parametrize("l2", [False, True], ids=["dot", "l2"])
def test_hv_attention_grad_of_jvp_float64(l2):
    # a self-attention layer as the discriminator runs it in the R1
    # surrogate: projections, the null token concatenated, split heads at
    # flash sizes (256 queries), under torch.func.jvp; the gradient of the
    # tangent against plain autograd of the reference math
    f64 = dict(dtype=torch.float64)
    gen = torch.Generator().manual_seed(47)
    b, n, dim, heads, dh = 1, 256, 6, 2, 3
    x = torch.randn(b, n, dim, generator=gen, **f64)
    u = torch.randn(b, n, dim, generator=gen, **f64)
    params = [torch.randn(dim, heads * dh, generator=gen, **f64) * 0.5
              for _ in range(3)]
    params.append(torch.randn(2, heads, dh, generator=gen, **f64))
    params = [p.requires_grad_() for p in params]

    def grads(attention):
        def layer(x_):
            wq, wk, wv, null_kv = params
            q = x_ @ wq
            k = q if l2 else x_ @ wk
            out = attention(torch.tanh(q), k, x_ @ wv, heads, null_kv, l2)
            return (torch.sin(out) * out).sum()

        _, s = torch.func.jvp(layer, (x,), (u,))
        return torch.autograd.grad(s, params, allow_unused=True)

    launches = []
    fwd = k7._AttendJvpPair.forward
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k7._AttendJvpPair, "forward", staticmethod(
            lambda *a: launches.append(1) or fwd(*a)))
        with k7.flash_hv_mode():
            got = grads(lambda q, k, v, heads_, null_kv, l2_: attend_fused(
                q, k, v, heads=heads_, null_kv=null_kv, l2_dist=l2_))
    assert launches == [1]  # the route went through the jvp pair
    want = grads(reference_attention)
    for name, g, w_ in zip(("wq", "wk", "wv", "null_kv"), got, want):
        if l2 and name == "wk":  # L2 attention shares q and k
            assert g is None and w_ is None
            continue
        torch.testing.assert_close(g, w_, rtol=1e-9, atol=1e-10, msg=name)


def test_flash_attend_gradchecks():
    f64 = dict(dtype=torch.float64)
    gen = torch.Generator().manual_seed(48)
    q, k, v = (torch.randn(1, 2, n, 3, generator=gen, **f64).requires_grad_()
               for n in (5, 6, 6))
    mask = torch.tensor([[True, True, False, True, False, True]])
    for l2 in (False, True):
        assert torch.autograd.gradcheck(
            lambda a, b_, c: k7.flash_attend_hv(a, b_, c, mask, l2),
            (q, k, v))
        # K6b is first-order only: a double backward raises
        out = k7.flash_attend_hv(q, k, v, mask, l2)
        (gq,) = torch.autograd.grad(out.square().sum(), q, create_graph=True)
        with pytest.raises(RuntimeError, match="once_differentiable"):
            gq.sum().backward()


# every implementation of K6a, K6b, K7a and K7b, each with its own count
HV_ENTRIES = (k6.flash_attention_fwd_tc, k6.flash_attention_fwd_simt,
              k6.flash_attention_bwd_tc, k6.flash_attention_bwd_simt,
              k7.flash_attention_hv_jvp_tc, k7.flash_attention_hv_jvp_simt,
              k7.flash_attention_hv_bwd_tc, k7.flash_attention_hv_bwd_simt)


def test_hv_wrappers_never_fall_back_off_the_cpu():
    meta = dict(device="meta")
    q = torch.empty(2, 16, 64, **meta)
    bias = torch.empty(2, 16, **meta)
    lse = torch.empty(2, 16, **meta)
    before = [f.launches for f in HV_ENTRIES]
    with pytest.raises(ValueError, match="on meta"):
        k6.flash_attention_fwd(q, q, q, bias)
    with pytest.raises(ValueError, match="on meta"):
        k6.flash_attention_bwd(q, q, q, bias, q, q, lse)
    # each K6 implementation called directly, in the dtype it takes
    for dtype, route in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
        qd = q.to(dtype)
        with pytest.raises(ValueError, match="on meta"):
            getattr(k6, f"flash_attention_fwd_{route}")(qd, qd, qd, bias)
        with pytest.raises(ValueError, match="on meta"):
            getattr(k6, f"flash_attention_bwd_{route}")(qd, qd, qd, bias, qd,
                                                        qd, lse)
    with pytest.raises(ValueError, match="on meta"):
        k7.flash_attention_hv_jvp(q, q, q, bias, q, q, q, bias)
    with pytest.raises(ValueError, match="on meta"):
        k7.flash_attention_hv_bwd(q, q, q, bias, q, q, q, bias, lse, None, q)
    # each K7 implementation called directly, in the dtype it takes, with
    # and without the cotangent of out
    for dtype, route in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
        qd = q.to(dtype)
        with pytest.raises(ValueError, match="on meta"):
            getattr(k7, f"flash_attention_hv_jvp_{route}")(
                qd, qd, qd, bias, qd, qd, qd, bias)
        for go in (None, qd):
            with pytest.raises(ValueError, match="on meta"):
                getattr(k7, f"flash_attention_hv_bwd_{route}")(
                    qd, qd, qd, bias, qd, qd, qd, bias, lse, go, qd)
    d128 = torch.empty(2, 16, 128, **meta)  # in range: only the device
    with pytest.raises(ValueError, match="on meta"):
        k7.flash_attention_hv_jvp(d128, d128, d128, bias, d128, d128, d128,
                                  bias)
    with pytest.raises(ValueError, match="on meta"):
        k7.flash_attention_hv_bwd(d128, d128, d128, bias, d128, d128, d128,
                                  bias, lse, None, d128)
    wide = torch.empty(2, 16, 136, **meta)
    with pytest.raises(ValueError, match="head dim 136 > 128"):
        k7.flash_attention_hv_jvp(wide, wide, wide, bias, wide, wide, wide,
                                  bias)
    with pytest.raises(ValueError, match="head dim 136 > 128"):
        k7.flash_attention_hv_bwd(wide, wide, wide, bias, wide, wide, wide,
                                  bias, lse, None, wide)
    q_cpu, k_cpu, v_cpu = (t(a) for a in qkv(49, nq=256, nk=128))
    attend(q_cpu, k_cpu, v_cpu)
    assert [f.launches for f in HV_ENTRIES] == before


def _k6_standins(monkeypatch):
    """K6a's and K6b's implementations replaced by stand-ins that count
    their calls and return outputs of the right shapes; by entry name."""
    entries = {}
    for kname in ("fwd", "bwd"):
        for route in ("tc", "simt"):
            name = f"flash_attention_{kname}_{route}"

            def entry(q, k_pre, v, bias, *rest, _name=name):
                entries[_name].append(q.shape[0])
                if rest:
                    return q, k_pre, v, bias
                return q, torch.empty(q.shape[:2], device=q.device)

            entries[name] = []
            monkeypatch.setattr(k6, name, entry)
    return entries


# K6a and K6b dispatch by K3/K4's rule: bf16 at head dim 64 or 128 to the
# tensor cores, everything else to the CUDA cores
K6_DISPATCH = [(torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
               (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
               (torch.bfloat16, 80, "simt"), (torch.bfloat16, 32, "simt")]


@pytest.mark.parametrize(
    "dtype,d,route", K6_DISPATCH,
    ids=[f"{str(dt).split('.')[-1]}-d{d}" for dt, d, _ in K6_DISPATCH])
def test_k6_dispatch_rule(dtype, d, route, monkeypatch):
    entries = _k6_standins(monkeypatch)
    assert k3.uses_tensor_cores(dtype, d) == (route == "tc")
    q = torch.empty(4, 16, d, dtype=dtype, device="meta")
    bias = torch.empty(4, 16, device="meta")
    k6.flash_attention_fwd(q, q, q, bias)
    k6.flash_attention_bwd(q, q, q, bias, q, q, bias)
    assert entries == {f"flash_attention_{k}_{r}": [4] if r == route else []
                       for k in ("fwd", "bwd") for r in ("tc", "simt")}


@pytest.mark.parametrize("route", ["tc", "simt"])
def test_k6_dispatch_splits_rows_past_the_grid_limit(route, monkeypatch):
    # b·h past MAX_ROWS runs as launches of at most MAX_ROWS rows each, the
    # outputs concatenated in order
    entries = _k6_standins(monkeypatch)
    monkeypatch.setattr(k6, "MAX_ROWS", 3)
    dtype = torch.bfloat16 if route == "tc" else torch.float32
    q = torch.empty(8, 16, 64, dtype=dtype, device="meta")
    bias = torch.empty(8, 16, device="meta")
    out, lse = k6.flash_attention_fwd(q, q, q, bias)
    grads = k6.flash_attention_bwd(q, q, q, bias, q, q, lse)
    assert out.shape == q.shape and lse.shape == (8, 16)
    assert [g_.shape for g_ in grads] == [q.shape] * 3 + [bias.shape]
    assert entries[f"flash_attention_fwd_{route}"] == [3, 3, 2]
    assert entries[f"flash_attention_bwd_{route}"] == [3, 3, 2]


@pytest.mark.parametrize("l2", [False, True], ids=["dot", "l2"])
def test_k6_row_split_matches_one_call(l2):
    # the split the dispatchers make past MAX_ROWS, at a chunk of 3 rows on
    # the plain versions: the same out, lse and gradients as one call
    q, k, v = qkv(56, b=2, h=4, nq=20, nk=24)
    ops = k6.prep_split(t(q), t(k), t(v), t(key_mask(57, 2, 24)), l2,
                        16 ** -0.5)
    out, lse = k6.flash_attention_fwd_plain(*ops)
    split = k6.by_rows(k6.flash_attention_fwd_plain, *ops, chunk=3)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(58))
    grads = k6.flash_attention_bwd_plain(*ops, g, out, lse)
    split_grads = k6.by_rows(k6.flash_attention_bwd_plain, *ops, g, out, lse,
                             chunk=3)
    for got, want in zip((*split, *split_grads), (out, lse, *grads)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [64, 80])
def test_k6_on_cpu_runs_plain_and_launches_nothing(d):
    # bf16 CPU tensors, whichever implementation the rule would pick on the
    # card: the wrappers return the plain versions' results, and no counter
    # moves
    before = [f.launches for f in HV_ENTRIES]
    q, k, v = (t(a).bfloat16() for a in qkv(59, nq=20, nk=24, d=d))
    ops = k6.prep_split(q, k, v, t(key_mask(60, 2, 24)), True, d ** -0.5)
    out, lse = k6.flash_attention_fwd(*ops)
    want = k6.flash_attention_fwd_plain(*ops)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    g = out.clone()
    for got, want_ in zip(k6.flash_attention_bwd(*ops, g, out, lse),
                          k6.flash_attention_bwd_plain(*ops, g, out, lse)):
        assert torch.equal(got, want_)
    assert [f.launches for f in HV_ENTRIES] == before


def _k7_standins(monkeypatch):
    """K7a's and K7b's implementations replaced by stand-ins that count
    their calls (b·h rows, and whether ĝo came) and return outputs of the
    right shapes; by entry name."""
    entries = {}
    for route in ("tc", "simt"):
        def jvp(q, k_pre, v, bias, tq, tk_pre, tv, tbias,
                _name=f"flash_attention_hv_jvp_{route}"):
            entries[_name].append(q.shape[0])
            return q, tq, torch.empty(q.shape[:2], device=q.device)

        def bwd(q, k_pre, v, bias, tq, tk_pre, tv, tbias, lse, go, gt,
                _name=f"flash_attention_hv_bwd_{route}"):
            entries[_name].append((q.shape[0], go is not None))
            if go is not None:
                assert go.shape[0] == q.shape[0]
            return q, k_pre, v, bias, tq, tk_pre, tv, tbias

        for name, fn in ((f"flash_attention_hv_jvp_{route}", jvp),
                         (f"flash_attention_hv_bwd_{route}", bwd)):
            entries[name] = []
            monkeypatch.setattr(k7, name, fn)
    return entries


# K7a and K7b dispatch by their own rule: bf16 at head dim 64 to the tensor
# cores, everything else (d = 128 among it) to the CUDA cores
K7_DISPATCH = [(torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "simt"),
               (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
               (torch.bfloat16, 80, "simt"), (torch.bfloat16, 32, "simt")]


@pytest.mark.parametrize(
    "dtype,d,route", K7_DISPATCH,
    ids=[f"{str(dt).split('.')[-1]}-d{d}" for dt, d, _ in K7_DISPATCH])
def test_k7_dispatch_rule(dtype, d, route, monkeypatch):
    entries = _k7_standins(monkeypatch)
    assert k7.hv_uses_tensor_cores(dtype, d) == (route == "tc")
    q = torch.empty(4, 16, d, dtype=dtype, device="meta")
    bias = torch.empty(4, 16, device="meta")
    k7.flash_attention_hv_jvp(q, q, q, bias, q, q, q, bias)
    k7.flash_attention_hv_bwd(q, q, q, bias, q, q, q, bias, bias, None, q)
    assert entries == {
        f"flash_attention_hv_{k}_{r}": (
            ([4] if k == "jvp" else [(4, False)]) if r == route else [])
        for k in ("jvp", "bwd") for r in ("tc", "simt")}


@pytest.mark.parametrize("with_go", [False, True], ids=["no_go", "go"])
@pytest.mark.parametrize("route", ["tc", "simt"])
def test_k7_dispatch_splits_rows_past_the_grid_limit(route, with_go,
                                                     monkeypatch):
    # b·h past MAX_ROWS runs as launches of at most MAX_ROWS rows each, the
    # outputs concatenated in order; an absent ĝo stays absent in every
    # chunk, a given one is split with the rest
    entries = _k7_standins(monkeypatch)
    monkeypatch.setattr(k6, "MAX_ROWS", 3)
    dtype = torch.bfloat16 if route == "tc" else torch.float32
    q = torch.empty(8, 16, 64, dtype=dtype, device="meta")
    bias = torch.empty(8, 16, device="meta")
    out, tout, lse = k7.flash_attention_hv_jvp(q, q, q, bias, q, q, q, bias)
    assert out.shape == tout.shape == q.shape and lse.shape == (8, 16)
    grads = k7.flash_attention_hv_bwd(q, q, q, bias, q, q, q, bias, lse,
                                      q if with_go else None, q)
    assert [g_.shape for g_ in grads] == (
        [q.shape] * 3 + [bias.shape] + [q.shape] * 3 + [bias.shape])
    assert entries[f"flash_attention_hv_jvp_{route}"] == [3, 3, 2]
    assert entries[f"flash_attention_hv_bwd_{route}"] == [
        (3, with_go), (3, with_go), (2, with_go)]


@pytest.mark.parametrize("with_go", [False, True], ids=["no_go", "go"])
def test_k7_row_split_matches_one_call(with_go):
    # the split the dispatchers make past MAX_ROWS, at a chunk of 3 rows on
    # the plain versions: the same out, tout, lse and cotangents as one call
    b, h, nq, nk, d = 2, 4, 20, 24, 16
    q, k, v, tq, tk, tv = qkv(61, b, h, nq, nk, d, tangents=True)
    mask = t(key_mask(62, b, nk))
    ops = k6.prep_split(t(q), t(k), t(v), mask, True, d ** -0.5)
    tang = (*k7.prep_tangents(t(q), t(k), t(tq), t(tk), mask, True,
                              d ** -0.5), t(tv).reshape(b * h, nk, d))
    tang = (tang[0], tang[1], tang[3], tang[2])  # tq, t̂k, tv, tbias
    fwd = k7.flash_attention_hv_jvp_plain(*ops, *tang)
    split = k6.by_rows(k7.flash_attention_hv_jvp_plain, *ops, *tang, chunk=3)
    gen = torch.Generator().manual_seed(63)
    go = torch.randn(fwd[0].shape, generator=gen) if with_go else None
    gt = torch.randn(fwd[0].shape, generator=gen)
    grads = k7.flash_attention_hv_bwd_plain(*ops, *tang, fwd[2], go, gt)
    split_grads = k6.by_rows(k7.flash_attention_hv_bwd_plain, *ops, *tang,
                             fwd[2], go, gt, chunk=3)
    for got, want in zip((*split, *split_grads), (*fwd, *grads)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [64, 80])
def test_k7_on_cpu_runs_plain_and_launches_nothing(d):
    # bf16 CPU tensors, whichever implementation the rule would pick on the
    # card: the wrappers return the plain versions' results, and no counter
    # moves
    before = [f.launches for f in HV_ENTRIES]
    q, k, v, tq, tk, tv = (t(a).bfloat16() for a in qkv(64, nq=20, nk=24,
                                                         d=d, tangents=True))
    mask = t(key_mask(65, 2, 24))
    ops = k6.prep_split(q, k, v, mask, True, d ** -0.5)
    tq_, tk_pre, tbias = k7.prep_tangents(q, k, tq, tk, mask, True,
                                          d ** -0.5)
    tang = (tq_, tk_pre, tv.reshape(4, 24, d), tbias)
    got = k7.flash_attention_hv_jvp(*ops, *tang)
    want = k7.flash_attention_hv_jvp_plain(*ops, *tang)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    for go in (None, got[0]):
        got_b = k7.flash_attention_hv_bwd(*ops, *tang, got[2], go, got[1])
        want_b = k7.flash_attention_hv_bwd_plain(*ops, *tang, got[2], go,
                                                 got[1])
        assert all(torch.equal(a, w) for a, w in zip(got_b, want_b))
    assert [f.launches for f in HV_ENTRIES] == before


# -------------------------------------------------------------- dispatch

@pytest.fixture
def plain_calls(monkeypatch):
    """Calls of the kernels' plain versions (what a CPU tensor runs in
    place of each launch), by kernel."""
    calls = {}
    for name, mod, fn in (
        ("k3", k3, "flash_attention_fused_fwd_plain"),
        ("k6a", k6, "flash_attention_fwd_plain"),
        ("k6b", k6, "flash_attention_bwd_plain"),
        ("k7a", k7, "flash_attention_hv_jvp_plain"),
        ("k7b", k7, "flash_attention_hv_bwd_plain"),
    ):
        orig = getattr(mod, fn)

        def counted(*args, _orig=orig, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*args)

        monkeypatch.setattr(mod, fn, counted)
    return calls


def fused_inputs(seed, n=256, heads=2, d=8):
    rng = np.random.default_rng(seed)
    q, k, v = (t(rng.standard_normal((1, n, heads * d)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    null_kv = t(rng.standard_normal((2, heads, d)).astype(np.float32))
    return q, k, v, null_kv.requires_grad_()


def test_fused_chain_unchanged_outside_hv_mode(plain_calls):
    q, k, v, null_kv = fused_inputs(50)
    out = attend_fused(q, k, v, heads=2, null_kv=null_kv, l2_dist=True)
    out.sum().backward()
    assert plain_calls == {"k3": 1}
    assert type(out.grad_fn).__name__ == "_FusedAttentionBackward"


def test_hv_mode_routes_attend_fused_to_split_heads(plain_calls):
    q, k, v, null_kv = fused_inputs(51)
    u = [torch.randn_like(a) for a in (q, k, v)]

    def layer(q_, k_, v_):
        return attend_fused(q_, k_, v_, heads=2, null_kv=null_kv,
                            l2_dist=True)

    with k7.flash_hv_mode():
        out, tout = torch.func.jvp(layer, (q, k, v), tuple(u))
    ((tout ** 2).sum() + (out ** 2).sum()).backward()
    assert plain_calls == {"k6a": 1, "k7a": 1, "k6b": 1, "k7b": 1}
    want = layer(q, k, v)
    assert rel_max(out.detach().numpy(), want.detach().numpy()) <= 1e-5
    assert null_kv.grad is not None and q.grad is not None


def through(out):
    """The Function node under the (b·h → b, h) reshape of the output."""
    return type(out.grad_fn.next_functions[0][0]).__name__


def test_attend_dispatch_by_size_and_mode(plain_calls):
    big = [t(a).requires_grad_()
           for a in qkv(52, b=1, h=1, nq=256, nk=128, d=8)]
    small = [t(a) for a in qkv(53, b=1, h=1, nq=255, nk=128, d=8)]
    attend(*small)
    assert plain_calls == {}
    out = attend(*big, l2_dist=True)
    assert plain_calls == {"k6a": 1}
    assert through(out) == "_FlashAttendHVBackward"
    with k7.flash_hv_mode():
        out_hv = attend(*big)
    assert plain_calls == {"k6a": 2}
    assert through(out_hv) == "_FlashAttendHVBackward"
    with plain_reference():
        want = attend(*big, l2_dist=True)
        with k7.flash_hv_mode():
            attend(*big)
    assert plain_calls == {"k6a": 2}
    assert rel_max(out.detach().numpy(), want.detach().numpy()) <= 1e-5
