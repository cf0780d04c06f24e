"""The port's UNet upsampler and its trainer against the JAX package on the
CPU, at tests/test_upsampler.py's small sizes (dim 8, 8 → 32,
``dim_mults=(1, 2)``): the forward (image, an image through a
video-capable net, video, text-conditioned) and its parameter gradients,
the fresh init's distributions (the identity temporal conv and the ICNR
inits included), the rank-1 adaptive conv and the linear attention, the
trainer's surface; and the batch split of the fused attention chain K3 →
K4 → K5 past the kernels' grid limit.  The ``train_upsampler`` d/g steps
are in tests/test_torch_upsampler_steps.py.

Both sides run the same parameters (the weight bridge), inputs and style
latents.  Tolerances: outputs and every rgb as tests/test_torch_models.py
holds the generator (rtol 5e-3, atol 5e-4); parameter gradients, per
leaf, within 1e-3 of the leaf's largest element; the ops 1e-5 relative to
the largest element."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu import ops as jops  # noqa: E402
from gigagan_tpu.models.unet_upsampler import (  # noqa: E402
    UnetUpsampler as JaxUpsampler,
)
from gigagan_tpu.utils.init import pixel_shuffle_icnr_init  # noqa: E402
from test_torch_train import (  # noqa: E402
    D_CFG,
    check_leaves,
    grads_within,
    random_params,
)

from gigagan_tpu_torch import GigaGAN, ops  # noqa: E402
from gigagan_tpu_torch.convert import convert_params  # noqa: E402
from gigagan_tpu_torch.data import MockImageDataset  # noqa: E402
from gigagan_tpu_torch.models.layers import init_parameters  # noqa: E402
from gigagan_tpu_torch.models.unet_upsampler import (  # noqa: E402
    UnetUpsampler,
)
from gigagan_tpu_torch.ops.kernels import (  # noqa: E402
    flash_attention_fused as k3,
)
from gigagan_tpu_torch.ops.kernels import (  # noqa: E402
    flash_attention_so as k45,
)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(dim=8, image_size=32, input_image_size=8, dim_mults=(1, 2),
             full_attn=(False, True), cross_attn=(False, False),
             attn_depths=(1, 1), temporal_attn_depths=(1, 1),
             num_conv_kernels=2, unconditional=True,
             style_network=dict(dim=16, depth=1))
TEXT = dict(SMALL, unconditional=False, cross_attn=(False, True),
            text_encoder=dict(dim=16, depth=1, clip_dim=24),
            style_network=dict(dim=16, depth=1, dim_text_latent=16))
KEYS = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
        "latent": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}

# case → (config, input shape, init input shape, text encodings?)
CASES = {
    "image": (SMALL, (2, 8, 8, 3), (2, 8, 8, 3), False),
    "image_through_video_net": (dict(SMALL, has_temporal_layers=True),
                                (2, 8, 8, 3), (1, 4, 8, 8, 3), False),
    "video": (dict(SMALL, has_temporal_layers=True), (1, 4, 8, 8, 3),
              (1, 4, 8, 8, 3), False),
    "text": (TEXT, (2, 8, 8, 3), (2, 8, 8, 3), True),
}


def jax_params(config, init_shape, text, seed):
    jm = JaxUpsampler(**config)
    kwargs = {"text_encodings": jnp.zeros((init_shape[0], 7, 24))} \
        if text else {}
    shapes = jax.eval_shape(lambda: jm.init(KEYS, jnp.zeros(init_shape),
                                            **kwargs))["params"]
    return jm, random_params(shapes, seed)


@pytest.mark.parametrize("case", list(CASES))
def test_upsampler_matches_jax(case):
    config, shape, init_shape, text = CASES[case]
    jm, params = jax_params(config, init_shape, text, seed=20)
    rng = np.random.default_rng(21)
    lowres = rng.random(shape).astype(np.float32)
    noise = rng.standard_normal((shape[0], 16)).astype(np.float32)
    enc = rng.standard_normal((shape[0], 7, 24)).astype(np.float32)
    kwargs = dict(text_encodings=enc) if text else {}
    out_shape = jax.eval_shape(lambda: jm.apply(
        {"params": params}, jnp.asarray(lowres), noise=jnp.asarray(noise),
        **kwargs)).shape
    cot = rng.standard_normal(out_shape).astype(np.float32)

    @jax.jit
    def scalar(p):
        out, rgbs = jm.apply({"params": p}, jnp.asarray(lowres),
                             noise=jnp.asarray(noise), return_all_rgbs=True,
                             **kwargs)
        return jnp.sum(out * cot), (out, rgbs)

    (_, (out_j, rgbs_j)), grads_j = jax.value_and_grad(
        scalar, has_aux=True)(params)

    model = UnetUpsampler(**config)
    model.load_state_dict(convert_params(params, model))
    out, rgbs = model(t(lowres), noise=t(noise), return_all_rgbs=True,
                      **{k: t(v) for k, v in kwargs.items()})
    assert out.shape == out_j.shape and len(rgbs) == len(rgbs_j) == 3
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=5e-3,
                               atol=5e-4)
    for i, (a, b) in enumerate(zip(rgbs, rgbs_j)):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=5e-3,
                                   atol=5e-4, err_msg=f"rgb {i}")
    np.testing.assert_array_equal(rgbs[0].detach().numpy(), lowres)
    (out * t(cot)).sum().backward()

    def check(name, p, want, what):
        if p.grad is None:  # a temporal part an image does not reach
            assert case == "image_through_video_net" and not want.any(), name
        else:
            grads_within(name, p, want, what)

    check_leaves(model, grads_j, f"{case} grads", check)


def test_allowable_rgb_resolutions_and_video_frames():
    # the rgbs larger than the input and the input, as JAX's; a video's
    # frames double per up stage and halve per pooling down stage
    model = UnetUpsampler(**dict(SMALL, has_temporal_layers=True))
    assert model.allowable_rgb_resolutions == [8, 16]
    with torch.no_grad():
        out = model(torch.rand(1, 4, 8, 8, 3), noise=torch.randn(1, 16))
    assert out.shape == (1, 16, 32, 32, 3)


def test_video_backward_hands_the_kernels_contiguous_operands(monkeypatch):
    # the temporal blocks fold space into the batch with a permute, so the
    # cotangent that reaches an adaptive conv's backward is not contiguous;
    # K1 and K2 take contiguous operands only (on the card they raise)
    from gigagan_tpu_torch.ops.kernels import adaptive_conv as k1m

    seen = []
    for name in ("adaptive_conv_fwd", "adaptive_conv_bwd_w"):
        def checked(*operands, _base=getattr(k1m, name), _name=name):
            seen.append(_name)
            assert all(o.is_contiguous() for o in operands), _name
            return _base(*operands)

        monkeypatch.setattr(k1m, name, checked)
    model = UnetUpsampler(**dict(SMALL, has_temporal_layers=True))
    init_parameters(model, torch.Generator().manual_seed(0))
    model(torch.rand(1, 4, 8, 8, 3), noise=torch.randn(1, 16)).sum().backward()
    assert {"adaptive_conv_fwd", "adaptive_conv_bwd_w"} <= set(seen)


def test_port_init_has_the_jax_distributions():
    # the port's own init: the same per-leaf scale as flax's; the identity
    # temporal conv exactly; the ICNR kernels tiled as JAX tiles them
    config = dict(SMALL, has_temporal_layers=True)
    jm = JaxUpsampler(**config)
    jparams = jax.device_get(jax.jit(jm.init)(
        KEYS, jnp.zeros((1, 4, 8, 8, 3)))["params"])
    model = UnetUpsampler(**config)
    init_parameters(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    for key, want in convert_params(jparams, model).items():
        got = state[key]
        if float(want.std()) == 0.0 or key.endswith("conv1d.weight"):
            assert torch.equal(got, want), key  # zeros, ones, identity
            continue
        if want.numel() < 500:
            continue
        ratio = float(got.std() / want.std())
        assert 0.85 < ratio < 1.15, (key, ratio)
        assert abs(float(got.mean())) < 0.1 * float(want.std()) + 1e-3, key
    for key, factor in (("ups.0.upsample.conv.weight", 4),
                        ("ups.0.temporal_upsample.conv.weight", 2)):
        w = state[key].numpy()
        tiles = w.reshape(w.shape[0] // factor, factor, w.shape[1])
        assert (tiles == tiles[:, :1]).all(), key
        bound = np.sqrt(1.0 / w.shape[1])
        assert 0.9 * bound < np.abs(w).max() <= bound, key
    want = np.asarray(pixel_shuffle_icnr_init(2)(
        jax.random.PRNGKey(0), (64, 128))).T
    tiles = want.reshape(64, 2, 64)
    assert (tiles == tiles[:, :1]).all()


# ------------------------------------------------------------------- ops

def rel_close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("banks", [2, 1])
def test_rank1_adaptive_conv_matches_jax(banks):
    # (b, t, c) maps, (n, k, i, o) banks, the modulations of b/2 samples
    # expanded batch-major (as the space-folded temporal blocks take them)
    rng = np.random.default_rng(30 + banks)
    x = rng.standard_normal((4, 6, 8)).astype(np.float32)
    w = (rng.standard_normal((banks, 3, 8, 12)) * 0.3).astype(np.float32)
    mod = (rng.standard_normal((2, 8)) * 0.3).astype(np.float32)
    kmod = rng.standard_normal((2, banks)).astype(np.float32) \
        if banks > 1 else None
    cot = rng.standard_normal((4, 6, 12)).astype(np.float32)
    inputs = [x, w, mod] + ([kmod] if kmod is not None else [])

    def jfn(*a):
        return jnp.sum(jops.adaptive_conv(*a[:3], a[3] if len(a) > 3
                                          else None) * cot)

    want = jops.adaptive_conv(*[jnp.asarray(a) for a in inputs[:3]],
                              None if kmod is None else jnp.asarray(kmod))
    want_grads = jax.grad(jfn, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(a) for a in inputs])
    ts = [t(a).requires_grad_() for a in inputs]
    got = ops.adaptive_conv(ts[0], ts[1], ts[2],
                            ts[3] if len(ts) > 3 else None)
    rel_close(got.detach(), want, what="values")
    (got * t(cot)).sum().backward()
    for name, a, g in zip(("x", "weights", "mod", "kernel_mod"), ts,
                          want_grads):
        rel_close(a.grad, g, what=name)
    ref = ops.adaptive_conv_reference(*[t(a) for a in inputs[:3]],
                                      None if kmod is None else t(kmod))
    rel_close(ref, want, rel=1e-4, what="reference")


def test_linear_attention_matches_jax():
    rng = np.random.default_rng(40)
    heads, d = 4, 8
    q, k, v = (rng.standard_normal((2, 20, heads * d)).astype(np.float32)
               for _ in range(3))
    cot = rng.standard_normal(q.shape).astype(np.float32)
    jq = [jnp.asarray(a) for a in (q, k, v)]
    want = jops.linear_attend_fused(*jq, heads=heads)
    want_grads = jax.grad(lambda *a: jnp.sum(
        jops.linear_attend_fused(*a, heads=heads) * cot),
        argnums=(0, 1, 2))(*jq)
    ts = [t(a).requires_grad_() for a in (q, k, v)]
    got = ops.linear_attend_fused(*ts, heads=heads)
    rel_close(got.detach(), want, what="fused values")
    (got * t(cot)).sum().backward()
    for name, a, g in zip("qkv", ts, want_grads):
        rel_close(a.grad, g, what=f"d{name}")
    # the split-heads form is the same function
    split = [t(a).reshape(2, 20, heads, d).transpose(1, 2) for a in (q, k, v)]
    rel_close(ops.linear_attend(*split).transpose(1, 2).reshape(2, 20, -1),
              want, what="split heads")
    jsplit = [jnp.asarray(a.numpy()) for a in split]
    rel_close(ops.linear_attend(*split), jops.linear_attend(*jsplit),
              what="linear_attend")


# ---------------------------------------------------------------- trainer

# D_CFG's multiscale inputs, 16 and 8, are among the rgbs that 8 → 32 gives
UP_D = dict(D_CFG)
BATCH = 2


def small_trainer(tmp_path, **kw):
    return GigaGAN(generator=SMALL, discriminator=UP_D,
                   train_upsampler=True, device="cpu", seed=0,
                   model_folder=str(tmp_path / "models"),
                   results_folder=str(tmp_path / "results"), **kw)


def test_upsampler_trainer_trains_generates_and_resumes(tmp_path):
    gan = small_trainer(tmp_path, log_steps_every=1, num_samples=4,
                        save_and_sample_every=1000)
    gan.set_dataloader(MockImageDataset(32, length=8).get_dataloader(BATCH))
    log = gan.train(2)
    assert [r["step"] for r in log] == [1, 2]
    assert all(np.isfinite(v) for r in log for v in r.values())
    assert gan.steps == 3 and gan.resize_image_mode == "bilinear"
    # the sampling of step 1 wrote both grids
    assert sorted(p.name for p in (tmp_path / "results").iterdir()) == [
        "ema-sample-0.png", "sample-0.png"]

    lowres = np.random.default_rng(80).random((2, 8, 8, 3)).astype(
        np.float32)
    out = gan.generate(lowres, seed=3)
    assert out.shape == (2, 32, 32, 3) and out.dtype == np.float32
    np.testing.assert_array_equal(out, gan.generate(lowres_image=lowres,
                                                    seed=3))
    with pytest.raises(AssertionError, match="lowres image"):
        small_trainer(tmp_path).generate(lowres, lowres_image=lowres)

    ckpt = tmp_path / "resume.ckpt"
    gan.save(ckpt)
    other = small_trainer(tmp_path)
    other.load(ckpt, strict=True)
    for mod in ("G", "G_ema", "D"):
        for a, b in zip(getattr(gan, mod).state_dict().values(),
                        getattr(other, mod).state_dict().values()):
            assert torch.equal(a, b), mod
    assert other.steps == gan.steps
    real = np.random.default_rng(81).random((BATCH, 32, 32, 3)).astype(
        np.float32)
    for trainer in (gan, other):
        trainer.train_discriminator_step(real, apply_gradient_penalty=False,
                                         calc_multiscale_loss=True, seed=9)
        trainer.train_generator_step(real, calc_multiscale_loss=True,
                                     seed=9)
    for a, b in zip(gan.G.parameters(), other.G.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(AssertionError, match="takes the real batch"):
        gan.train_generator_step(BATCH, calc_multiscale_loss=True)


def test_upsampler_sample_grid_has_the_jax_layout(tmp_path, monkeypatch):
    # per group of the batch size, [nearest-upsampled low-res inputs;
    # outputs], from sample_upsampler_dl's batches; the grid twice as wide
    # (JAX's _sample_images and save_sample)
    from gigagan_tpu_torch.train import trainer as trainer_mod

    dl = MockImageDataset(32, length=8, seed=3).get_dataloader(2)
    gan = small_trainer(tmp_path, num_samples=4, sample_upsampler_dl=dl)
    grids = []
    monkeypatch.setattr(trainer_mod, "save_image_grid",
                        lambda images, path, nrow: grids.append(
                            (images, pathlib.Path(path).name, nrow)))
    gan.save_sample(2)
    assert [(g[1], g[2]) for g in grids] == [("sample-0.png", 4),
                                             ("ema-sample-0.png", 4)]
    images = grids[0][0]
    assert images.shape == (8, 32, 32, 3)
    batches = iter(MockImageDataset(32, length=8, seed=3).get_dataloader(2))
    for group in range(2):
        real = next(batches)
        real = real[0] if isinstance(real, tuple) else real
        lowres = ops.resize_image_to(t(np.asarray(real)), 8, "nearest")
        up = ops.resize_image_to(lowres, 32, "nearest").numpy()
        np.testing.assert_allclose(images[4 * group:4 * group + 2],
                                   np.clip(up, 0, 1))
    assert not np.allclose(images[2:4], images[:2])


# ------------------------------------------- K3-K5 past the grid limit

NULL = {True: "null", False: "no_null"}


def fused_operands(b, with_null, dtype=torch.float32, device="cpu",
                   seed=90):
    heads, nq, nk, d = 2, 5, 6, 8
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(device=device,
                                                    dtype=dtype)

    q, k, v = rnd(b, nq, heads * d), rnd(b, nk, heads * d), \
        rnd(b, nk, heads * d)
    null_kv = rnd(2, heads, d) if with_null else None
    prepped = k3.prep_fused(k, v, null_kv, heads, True, d ** -0.5)
    return q, prepped, heads


def _standins(monkeypatch):
    """K3-K5's implementations replaced by stand-ins that record the batch
    of each call and return outputs of the right shapes (the null
    gradients ones, so that their sum counts the chunks)."""
    calls = {}

    def record(name, b):
        calls.setdefault(name, []).append(b)

    def fwd(name):
        def entry(q, k_pre, v, bias, nk, nv, nb, heads):
            record(name, q.shape[0])
            b, nq, _ = q.shape
            return q.clone(), torch.zeros(b, heads, nq)
        return entry

    def bwd(name):
        def entry(q, k_pre, v, bias, nk, nv, nb, g, out, lse, heads):
            record(name, q.shape[0])
            nulls = [None if t_ is None else torch.ones(t_.shape)
                     for t_ in (nk, nv, nb)]
            return (q.clone(), k_pre.clone(), v.clone(),
                    None if bias is None else bias.clone(), *nulls)
        return entry

    def bwd2(name):
        def entry(q, k_pre, v, bias, nk, nv, nb, g, lse, *rest):
            record(name, q.shape[0])
            nulls = [None if t_ is None else torch.ones(t_.shape)
                     for t_ in (nk, nv, nb)]
            return (q.clone(), k_pre.clone(), v.clone(),
                    None if bias is None else bias.clone(), *nulls,
                    g.clone())
        return entry

    for route in ("tc", "simt"):
        monkeypatch.setattr(k3, f"flash_attention_fused_fwd_{route}",
                            fwd(f"k3_{route}"))
        monkeypatch.setattr(k45, f"flash_attention_fused_bwd_{route}",
                            bwd(f"k4_{route}"))
        monkeypatch.setattr(k45, f"flash_attention_so_bwd2_{route}",
                            bwd2(f"k5_{route}"))
    return calls


class _NotCpu(torch.Tensor):
    """A CPU tensor that says it is not on the CPU, so that the dispatchers
    take their kernel route (here the stand-ins)."""

    @property
    def device(self):
        return torch.device("meta")


@pytest.mark.parametrize("with_null", [True, False], ids=NULL.get)
def test_fused_chain_splits_the_batch_past_the_grid_limit(with_null,
                                                          monkeypatch):
    # a batch past MAX_BATCH runs as launches of at most MAX_BATCH samples,
    # the per-sample outputs concatenated in order and the null token's
    # gradients summed over the chunks
    calls = _standins(monkeypatch)
    monkeypatch.setattr(k3, "MAX_BATCH", 3)
    q, (k_pre, bias, nk, nv, nb), heads = fused_operands(8, with_null)
    q, v = q.as_subclass(_NotCpu), k_pre.clone()
    out, lse = k3.flash_attention_fused_fwd(q, k_pre, v, bias, nk, nv, nb,
                                            heads)
    assert out.shape == q.shape and lse.shape == (8, heads, q.shape[1])
    g = q.clone()
    grads = k45.flash_attention_fused_bwd(q, k_pre, v, bias, nk, nv, nb, g,
                                          out, lse, heads)
    cots = k45.flash_attention_so_bwd2(
        q, k_pre, v, bias, nk, nv, nb, g, lse, g, k_pre, v, bias, nk, nv,
        nb, heads)
    assert calls == {"k3_simt": [3, 3, 2], "k4_simt": [3, 3, 2],
                     "k5_simt": [3, 3, 2]}
    for got, want in ((grads[:4], (q, k_pre, v, bias)),
                      (cots[:4] + cots[7:], (q, k_pre, v, bias, g))):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    for null in (grads[4:7], cots[4:7]):
        if with_null:
            assert all(torch.equal(a, torch.full_like(a, 3.0))
                       for a in null)  # one per chunk
        else:
            assert null == (None, None, None)


@pytest.mark.parametrize("with_null", [True, False], ids=NULL.get)
def test_fused_chain_batch_split_matches_one_call(with_null):
    # the split the dispatchers make past MAX_BATCH, at a chunk of 3
    # samples on the plain versions: the same outputs, gradients and
    # adjoints as one call (the null sums in another order: 1e-5)
    q, (k_pre, bias, nk, nv, nb), heads = fused_operands(8, with_null,
                                                         seed=91)
    v = torch.randn_like(k_pre)
    args = (q, k_pre, v, bias, nk, nv, nb, heads)
    one = k3.flash_attention_fused_fwd_plain(*args)
    split = k3.by_batch(k3.flash_attention_fused_fwd_plain, args,
                        batched=(0, 1, 2, 3), chunk=3)
    g = torch.randn_like(q)
    bargs = (q, k_pre, v, bias, nk, nv, nb, g, *one, heads)
    gone = k45.flash_attention_fused_bwd_plain(*bargs)
    gsplit = k3.by_batch(k45.flash_attention_fused_bwd_plain, bargs,
                         batched=(0, 1, 2, 3, 7, 8, 9), summed=(4, 5, 6),
                         chunk=3)
    cot = [torch.randn_like(t_) if t_ is not None else None
           for t_ in (q, k_pre, v, bias, nk, nv, nb)]
    cargs = (q, k_pre, v, bias, nk, nv, nb, g, one[1], *cot, heads)
    cone = k45.flash_attention_so_bwd2_plain(*cargs)
    csplit = k3.by_batch(k45.flash_attention_so_bwd2_plain, cargs,
                         batched=(0, 1, 2, 3, 7, 8, 9, 10, 11, 12),
                         summed=(4, 5, 6), chunk=3)
    for got, want in zip((*split, *gsplit, *csplit), (*one, *gone, *cone)):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
