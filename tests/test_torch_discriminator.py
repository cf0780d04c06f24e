"""The PyTorch port's discriminator and its layers against their flax twins
on the CPU.  Parameters go through the weight bridge with every leaf set
to random values; the JAX side's random draws (the reconstruction
decoder's dropout mask and patch scores) are replaced by numpy draws that
the port receives explicitly."""

import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu import ops as jops  # noqa: E402
from gigagan_tpu.models import discriminator as jd  # noqa: E402
from gigagan_tpu.models import layers as jl  # noqa: E402

from gigagan_tpu_torch import ops  # noqa: E402
from gigagan_tpu_torch.convert import convert_params  # noqa: E402
from gigagan_tpu_torch.models import discriminator as td  # noqa: E402
from gigagan_tpu_torch.models import layers as tl  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tier-1 run puts several test processes on the cores; a torch
    thread pool per process would only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_params(shapes, seed):
    """Every leaf of a flax param-shape tree → random values at the scale
    its initializer would give (kernels by fan-in), biases and gains
    perturbed so that none is trivially zero or one."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name in ("kernel", "weights"):
            fan_in = int(np.prod(shape[:-1])) if name == "kernel" else int(
                np.prod(shape[1:-1]))
            std = np.sqrt(2.0 / fan_in)
        elif name == "gamma":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif name == "null_kv":
            std = 1.0
        else:
            std = 0.1
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@contextlib.contextmanager
def numpy_draws(seed):
    """Replace jax.random.{normal, uniform, bernoulli} with numpy draws of
    the requested shape, recorded in call order.  Works under jit: the
    draws are constants of the trace."""
    rng = np.random.default_rng(seed)
    record = []
    orig = (jax.random.normal, jax.random.uniform, jax.random.bernoulli)
    real_sites = ("models/generator.py", "models/layers.py",
                  "models/discriminator.py", "gigagan_tpu/losses.py")

    def from_model(fn):
        # flax re-runs initializers under eval_shape to check parameter
        # shapes; only the draws made by the model code itself count
        def draw(*args, **kwargs):
            caller = sys._getframe(1).f_code.co_filename
            if not caller.endswith(real_sites):
                return orig[("normal", "uniform", "bernoulli").index(
                    fn.__name__)](*args, **kwargs)
            return fn(*args, **kwargs)
        return draw

    @from_model

    def normal(key, shape=(), dtype=jnp.float32):
        a = rng.standard_normal(tuple(shape)).astype(np.float32)
        record.append(("normal", a))
        return jnp.asarray(a, dtype)

    @from_model
    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        a = rng.random(tuple(shape)).astype(np.float32)
        record.append(("uniform", a))
        return jnp.asarray(a, dtype)

    @from_model
    def bernoulli(key, p=0.5, shape=None):
        a = rng.random(tuple(shape)) < p
        record.append(("bernoulli", a))
        return jnp.asarray(a)

    jax.random.normal, jax.random.uniform, jax.random.bernoulli = (
        normal, uniform, bernoulli)
    try:
        yield record
    finally:
        jax.random.normal, jax.random.uniform, jax.random.bernoulli = orig


def recon_draws_from(record, num):
    """(keep, patch_idx) per decoder call from the recorded JAX draws:
    bernoulli → keep mask, uniform → patch scores → JAX's stable argsort."""
    draws, keep = [], None
    for kind, a in record:
        if kind == "bernoulli":
            keep = t(a)
        elif kind == "uniform":
            idx = np.argsort(a, axis=-1, kind="stable")[:, :num]
            draws.append((keep, t(idx)))
    return draws


# ----------------------------------------------------------------- resample

@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("size", [8, 5, 24])
def test_resize_image_to_matches_jax(method, size):
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    want = jops.resize_image_to(jnp.asarray(x), size, method)
    got = ops.resize_image_to(t(x), size, method)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- layers

B, H, C = 2, 8, 16
LAYER_CASES = {
    "blur": (lambda: jl.Blur(), lambda: tl.Blur()),
    "conv3x3": (lambda: jl.conv3x3(24), lambda: tl.conv3x3(C, 24)),
    "from_rgb_7x7": (
        lambda: jl.nn.Conv(12, (7, 7), padding="SAME"),
        lambda: tl.Conv(C, 12, kernel=7)),
    "residual_1x1_stride2": (
        lambda: jl.nn.Conv(12, (1, 1), strides=(2, 2)),
        lambda: tl.Conv(C, 12, kernel=1, stride=2)),
    "downsample": (lambda: jl.Downsample(20, in_s2d=False, out_s2d=False),
                   lambda: tl.Downsample(C, 20)),
    "predictor": (lambda: jd.Predictor(depth=2, unconditional=True),
                  lambda: td.Predictor(C, depth=2, unconditional=True)),
    "stage_core_attn": (
        lambda: jd.DStageCore(24, downsample=True, has_attn=True,
                              attn_heads=2, attn_dim_head=64),
        lambda: td.DStageCore(C, 24, downsample=True, has_attn=True,
                              attn_heads=2, attn_dim_head=64)),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_d_layer_matches_flax(name):
    make_jax, make_torch = LAYER_CASES[name]
    x = np.random.default_rng(1).standard_normal((B, H, H, C)).astype(
        np.float32)
    jmod = make_jax()
    params = random_params(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))).get(
            "params", {}), seed=2)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = make_torch()
    tmod.load_state_dict(convert_params(params, tmod))
    with torch.no_grad():
        got = tmod(t(x))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(
            [g.numpy() for g in (got if isinstance(got, tuple) else [got])])):
        assert rel_err(b, a) <= 1e-4, (name, rel_err(b, a))


def test_simple_decoder_matches_flax_with_explicit_draws():
    dec_j = jd.SimpleDecoder(dims=(8, 3), patch_dim=2, frac_patches=0.5)
    dec_t = td.SimpleDecoder(C, (8, 3), patch_dim=2, frac_patches=0.5)
    rng = np.random.default_rng(3)
    fmap = rng.standard_normal((B, 4, 4, C)).astype(np.float32)
    img = rng.random((B, 16, 16, 3)).astype(np.float32)
    params = random_params(jax.eval_shape(
        lambda: dec_j.init({"params": jax.random.PRNGKey(0),
                            "dropout": jax.random.PRNGKey(1)},
                           jnp.asarray(fmap), jnp.asarray(img)))["params"],
        seed=4)
    with numpy_draws(5) as record:
        want = dec_j.apply({"params": params}, jnp.asarray(fmap),
                           jnp.asarray(img),
                           rngs={"dropout": jax.random.PRNGKey(2)})
    (keep, idx), = recon_draws_from(record, num=2)
    dec_t.load_state_dict(convert_params(params, dec_t))
    with torch.no_grad():
        got = dec_t(t(fmap), t(img), keep=keep, patch_idx=idx)
    assert rel_err(got.numpy(), want) <= 1e-4


def test_simple_decoder_draws_from_its_generator():
    dec = td.SimpleDecoder(C, (3,), patch_dim=2, frac_patches=0.5)
    tl.init_parameters(dec, torch.Generator().manual_seed(0))
    fmap, img = torch.randn(B, 4, 4, C), torch.rand(B, 8, 8, 3)
    with torch.no_grad():
        a = dec(fmap, img, generator=torch.Generator().manual_seed(1))
        b = dec(fmap, img, generator=torch.Generator().manual_seed(1))
        c = dec(fmap, img, generator=torch.Generator().manual_seed(2))
        d = dec(fmap, img, deterministic=True)
    assert a == b and a != c and torch.isfinite(d)


# ------------------------------------------------------------ discriminator

D_CONFIG = dict(image_size=32, dim_capacity=4, dim_max=32, attn_heads=2,
                attn_dim_head=64, num_skip_layers_excite=1,
                unconditional=True)


@pytest.fixture(scope="module")
def jax_d_run():
    jdisc = jd.Discriminator(**D_CONFIG, s2d_trunk=False)
    rng = np.random.default_rng(6)
    images = rng.random((3, 32, 32, 3)).astype(np.float32)
    rgbs = [np.asarray(r) for r in
            jdisc.real_images_to_rgbs(jnp.asarray(images))]
    shapes = jax.eval_shape(lambda: jdisc.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(images), [jnp.asarray(r) for r in rgbs]))["params"]
    params = random_params(shapes, seed=7)
    apply = jax.jit(lambda p, i, r: jdisc.apply(
        {"params": p}, i, r, aux_recon_samples=2,
        rngs={"dropout": jax.random.PRNGKey(3)}))
    with numpy_draws(8) as record:
        logits, ms, aux = apply(params, jnp.asarray(images),
                                [jnp.asarray(r) for r in rgbs])
    return params, images, rgbs, record, (np.asarray(logits),
                                          [np.asarray(m) for m in ms],
                                          [np.asarray(a) for a in aux])


def test_discriminator_matches_flax(jax_d_run):
    params, images, rgbs, record, (logits_j, ms_j, aux_j) = jax_d_run
    disc = td.Discriminator(**D_CONFIG)
    assert disc.multiscale_input_resolutions == (16, 8)
    assert [s.core.attn is not None for s in disc.stages] == [
        True, True, False, False]
    disc.load_state_dict(convert_params(params, disc))
    rgbs_t = disc.real_images_to_rgbs(t(images))
    for a, b in zip(rgbs_t, rgbs):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)
    draws = recon_draws_from(record, num=1)
    with torch.no_grad():
        logits, ms, aux = disc(t(images), rgbs_t, aux_recon_samples=2,
                               recon_draws=draws)
    assert logits.shape == logits_j.shape == (4, 3)
    assert rel_err(logits.numpy(), logits_j) <= 1e-4
    assert len(ms) == len(ms_j) == 2
    for a, b in zip(ms, ms_j):
        assert a.shape == b.shape
        assert rel_err(a.numpy(), b) <= 1e-4
    assert len(aux) == len(aux_j) == 1
    assert rel_err(aux[0].numpy(), aux_j[0]) <= 1e-4


def test_remat_stages_matches_flax_remat(jax_d_run):
    # each stage core recomputed in the backward, on both sides (flax's
    # nn.remat(DStageCore)): the values, and the parameter gradients of the
    # outputs plus an R1 penalty on the input, whose double backward reruns
    # every stage
    params, images, _, _, (logits_j, _, _) = jax_d_run
    jdisc = jd.Discriminator(**D_CONFIG, s2d_trunk=False, remat_stages=True)

    def jax_outputs(p, x):
        lg, ms, _ = jdisc.apply({"params": p}, x,
                                jdisc.real_images_to_rgbs(x),
                                calc_aux_loss=False)
        return lg.sum() + sum(m.sum() for m in ms), lg

    def jax_loss(p, x):
        out, lg = jax_outputs(p, x)
        g = jax.grad(lambda x_: jax_outputs(p, x_)[0])(x)
        return out + jnp.sum(g * g), lg

    (loss_j, lg_j), grads_j = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(params, jnp.asarray(images))
    np.testing.assert_allclose(np.asarray(lg_j), logits_j, rtol=1e-5,
                               atol=1e-5)

    disc = td.Discriminator(**D_CONFIG, remat_stages=True)
    disc.load_state_dict(convert_params(params, disc))
    x = t(images).requires_grad_()
    lg, ms, _ = disc(x, disc.real_images_to_rgbs(x), calc_aux_loss=False)
    out = lg.sum() + sum(m.sum() for m in ms)
    (g,) = torch.autograd.grad(out, x, create_graph=True)
    loss = out + (g * g).sum()
    loss.backward()
    assert rel_err(lg.detach().numpy(), logits_j) <= 1e-4
    assert rel_err(loss.item(), float(loss_j)) <= 1e-4
    want = convert_params(grads_j, disc)
    for name, p in disc.named_parameters():
        if p.grad is None:  # the reconstruction decoder, not run here
            assert "recon_decoder" in name and not want[name].any(), name
            continue
        assert rel_err(p.grad.numpy(), want[name].numpy()) <= 1e-3, name


def test_discriminator_bf16_runs_and_tracks_fp32(jax_d_run):
    params, images, rgbs, record, (logits_j, _, _) = jax_d_run
    disc = td.Discriminator(**D_CONFIG, dtype=torch.bfloat16)
    disc.load_state_dict(convert_params(params, disc))
    with torch.no_grad():
        logits, ms, aux = disc(t(images).bfloat16(),
                               [t(r).bfloat16() for r in rgbs],
                               deterministic=True)
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()
    assert rel_err(logits.float().numpy(), logits_j) <= 0.1


@pytest.mark.parametrize("kwargs,match", [
    (dict(unconditional=False), "exactly one of text_dim and text_encoder"),
])
def test_unported_discriminator_options_raise(kwargs, match):
    # the conditional discriminator is ported: without a text encoder or a
    # text dim it fails as JAX's setup assertion does (JAX's carries no
    # message: its failing statement is checked instead)
    config = {**D_CONFIG, **kwargs}
    with pytest.raises(AssertionError, match=match):
        td.Discriminator(**config)
    jdisc = jd.Discriminator(**config, s2d_trunk=False)
    images = jnp.zeros((1, 32, 32, 3))
    with pytest.raises(AssertionError) as caught:
        jdisc.init({"params": jax.random.PRNGKey(0),
                    "dropout": jax.random.PRNGKey(1)}, images,
                   jdisc.real_images_to_rgbs(images))
    statement = str(caught.traceback[-1].statement)
    assert "exists(self.text_dim) ^ exists(self.text_encoder)" in statement
