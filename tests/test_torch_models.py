"""The PyTorch port's layers and unconditional Generator against their flax
twins on the CPU.  Parameters go through the weight bridge; every leaf is
set to nonzero random values (noise weights and biases included), and
both sides get the same numpy inputs and the same per-layer pixel noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

torch = pytest.importorskip("torch")

from gigagan_tpu.models import conditioning as jc  # noqa: E402
from gigagan_tpu.models import layers as jl  # noqa: E402
from gigagan_tpu.models.generator import Generator as JaxGenerator  # noqa: E402

from gigagan_tpu_torch import GigaGAN  # noqa: E402
from gigagan_tpu_torch.convert import convert_params  # noqa: E402
from gigagan_tpu_torch.models import conditioning as tc  # noqa: E402
from gigagan_tpu_torch.models import layers as tl  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a))


def randomize(params, seed, scale=0.3):
    """Every leaf → nonzero N(0, scale²) values of the same shape."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
        jax.device_get(params),
    )


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


# ------------------------------------------------------------------ layers

def test_l2norm_matches_jax_and_clamps_inside_the_sqrt():
    x = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    x[1] = 0.0
    np.testing.assert_allclose(tl.l2norm(t(x)).numpy(), jl.l2norm(x),
                               rtol=1e-6, atol=1e-6)
    xt = t(x).requires_grad_()
    tl.l2norm(xt).sum().backward()
    assert torch.isfinite(xt.grad).all()


def test_leaky_relu_matches_jax():
    x = np.linspace(-3, 3, 13, dtype=np.float32)
    np.testing.assert_allclose(tl.leaky_relu(t(x)).numpy(), jl.leaky_relu(x),
                               rtol=1e-6)


B, H, W, C = 2, 8, 8, 16
FMAP = (B, H, W, C)

# name → (flax module, port module, input shapes, extra numpy kwargs)
LAYER_CASES = {
    "rmsnorm": (lambda: jl.RMSNorm(C), lambda: tl.RMSNorm(C), [FMAP]),
    "squeeze_excite": (lambda: jl.SqueezeExcite(24),
                       lambda: tl.SqueezeExcite(C, 24), [FMAP]),
    "noise": (lambda: jl.Noise(), lambda: tl.Noise(C), [FMAP, (B, H, W, 1)]),
    "equal_linear": (lambda: jl.EqualLinear(12, lr_mul=0.1),
                     lambda: tl.EqualLinear(C, 12, lr_mul=0.1), [(B, C)]),
    "adaptive_conv3x3": (
        lambda: jl.AdaptiveConv(24, kernel=3, num_conv_kernels=2),
        lambda: tl.AdaptiveConv(C, 24, kernel=3, num_conv_kernels=2),
        [FMAP, (B, C), (B, 2)]),
    "to_rgb": (
        lambda: jl.AdaptiveConv(3, kernel=1, num_conv_kernels=1,
                                demod=False),
        lambda: tl.AdaptiveConv(C, 3, kernel=1, num_conv_kernels=1,
                                demod=False),
        [FMAP, (B, C)]),
    "self_attention_dot": (
        lambda: jl.SelfAttention(C, dim_head=8, heads=2, dot_product=True),
        lambda: tl.SelfAttention(C, dim_head=8, heads=2, dot_product=True),
        [FMAP]),
    "self_attention_l2": (
        lambda: jl.SelfAttention(C, dim_head=8, heads=2, dot_product=False),
        lambda: tl.SelfAttention(C, dim_head=8, heads=2, dot_product=False),
        [FMAP]),
    "feed_forward": (lambda: jl.FeedForward(C, mult=2),
                     lambda: tl.FeedForward(C, mult=2), [FMAP]),
    "self_attention_block": (
        lambda: jl.SelfAttentionBlock(C, dim_head=8, heads=2, ff_mult=2,
                                      dot_product=True),
        lambda: tl.SelfAttentionBlock(C, dim_head=8, heads=2, ff_mult=2,
                                      dot_product=True),
        [FMAP]),
    "style_network": (lambda: jc.StyleNetwork(dim=C, depth=2),
                      lambda: tc.StyleNetwork(dim=C, depth=2), [(B, C)]),
    "pixel_shuffle_upsample": (lambda: jl.PixelShuffleUpsample(),
                               lambda: tl.PixelShuffleUpsample(C), [FMAP]),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_matches_flax(name):
    make_jax, make_torch, shapes = LAYER_CASES[name]
    rng = np.random.default_rng(1)
    inputs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jmod = make_jax()
    params = jmod.init(jax.random.PRNGKey(0),
                       *map(jnp.asarray, inputs))["params"]
    params = randomize(params, seed=2)
    want = jmod.apply({"params": params}, *map(jnp.asarray, inputs))

    tmod = make_torch()
    tmod.load_state_dict(convert_params(params, tmod))
    with torch.no_grad():
        got = tmod(*map(t, inputs))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------- generator

G_CONFIG = dict(
    image_size=32, dim_capacity=4, dim_max=64, dim_latent=32,
    style_network=dict(dim=16, depth=2),
    self_attn_resolutions=(16,), self_attn_dim_head=8, self_attn_heads=2,
    cross_attn_resolutions=(), num_conv_kernels=2,
    num_skip_layers_excite=2, unconditional=True,
)


def feed_noise_torch(module, noises):
    """Forward pre-hooks that hand each Noise layer its numpy noise, in
    call order, as the flax side's interceptor does."""
    it = iter(noises)

    def hook(mod, args, kwargs):
        n = t(next(it)).to(args[0].dtype)
        return args, dict(kwargs, noise=n)

    return [m.register_forward_pre_hook(hook, with_kwargs=True)
            for m in module.modules() if isinstance(m, tl.Noise)]


def test_pixel_shuffle_icnr_init_matches_jax():
    # the same ×4-tiled kaiming-uniform kernel: JAX's flax (in, out) kernel
    # repeats each column four times, the port's Linear (out, in) weight
    # each row; the same bound, and one seed's spread alike
    from gigagan_tpu.utils.init import pixel_shuffle_icnr_init

    dim_in, dim_out = 64, 64
    want = np.asarray(pixel_shuffle_icnr_init(4)(
        jax.random.PRNGKey(0), (dim_in, 4 * dim_out))).T
    layer = tl.PixelShuffleUpsample(dim_in, dim_out)
    tl.init_parameters(layer, torch.Generator().manual_seed(0))
    got = layer.conv.weight.detach().numpy()
    bound = np.sqrt(1.0 / dim_in)  # gain 1/sqrt(3) · sqrt(3 / fan_in)
    for w in (want, got):
        assert w.shape == (4 * dim_out, dim_in)
        tiles = w.reshape(dim_out, 4, dim_in)
        assert (tiles == tiles[:, :1]).all()
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.95 * bound
    assert 0.9 < got.std() / want.std() < 1.1
    assert not layer.conv.bias.detach().any()
    # the generator's upsamplers keep kaiming (use_icnr=False), as in JAX
    plain = tl.PixelShuffleUpsample(dim_in, dim_out, use_icnr=False)
    tl.init_parameters(plain, torch.Generator().manual_seed(0))
    w = plain.conv.weight.detach().numpy().reshape(dim_out, 4, dim_in)
    assert not (w == w[:, :1]).all()


def run_jax_generator(config):
    """(params, latents, pixel noises, out, rgbs) of one flax forward."""
    jg = JaxGenerator(**config, s2d_trunk=False)
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
            "latent": jax.random.PRNGKey(2)}
    params = randomize(jg.init(keys, batch_size=2)["params"], seed=3,
                       scale=0.5)
    # the initializers' scales where they matter for a sane forward
    for name, leaf in params.items():
        if "weights" in leaf:
            fan_in = np.prod(leaf["weights"].shape[1:-1])
            leaf["weights"] *= np.sqrt(2.0 / fan_in) / 0.5
        if "upsample" in name:  # the pixel shuffle's Dense
            kernel = leaf["conv"]["kernel"]
            kernel *= np.sqrt(2.0 / kernel.shape[0]) / 0.5
    rng = np.random.default_rng(4)
    latents = rng.standard_normal((2, 16)).astype(np.float32)
    noises = []

    def interceptor(next_fun, args, kwargs, context):
        if (isinstance(context.module, jl.Noise)
                and context.method_name == "__call__"):
            x = args[0]
            n = rng.standard_normal((*x.shape[:-1], 1)).astype(np.float32)
            noises.append(n)
            kwargs = dict(kwargs, noise=jnp.asarray(n))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(interceptor):
        out, rgbs = jg.apply({"params": params}, noise=jnp.asarray(latents),
                             return_all_rgbs=True)
    assert len(noises) == 2 * 4  # two Noise layers in each of 4 stages
    return params, latents, noises, np.asarray(out), [np.asarray(r)
                                                      for r in rgbs]


@pytest.fixture(scope="module")
def jax_generator_run():
    return run_jax_generator(G_CONFIG)


def port_forward(params, latents, noises, amp, config=G_CONFIG):
    gan = GigaGAN(generator=config, amp=amp, device="cpu", seed=0)
    gan.load_jax_params(params)
    hooks = feed_noise_torch(gan.G, noises)
    with torch.no_grad():
        out, rgbs = gan.G(noise=t(latents), return_all_rgbs=True)
    for h in hooks:
        h.remove()
    return out.float().numpy(), [r.float().numpy() for r in rgbs]


def test_generator_matches_jax_fp32(jax_generator_run):
    params, latents, noises, out_j, rgbs_j = jax_generator_run
    out, rgbs = port_forward(params, latents, noises, amp=False)
    assert len(rgbs) == len(rgbs_j) == 4
    np.testing.assert_allclose(out, out_j, rtol=5e-3, atol=5e-4)
    for i, (a, b) in enumerate(zip(rgbs, rgbs_j)):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4,
                                   err_msg=f"rgb pyramid level {i}")


def test_pixel_shuffle_generator_matches_jax():
    # every upsample (features and rgb) a 1x1 conv to 4x, SiLU and a pixel
    # shuffle; the weight bridge moves their Dense kernels
    config = dict(G_CONFIG, pixel_shuffle_upsample=True)
    params, latents, noises, out_j, rgbs_j = run_jax_generator(config)
    assert "conv" in params["stages_1_upsample"]
    assert "conv" in params["stages_0_upsample_rgb"]
    out, rgbs = port_forward(params, latents, noises, amp=False,
                             config=config)
    np.testing.assert_allclose(out, out_j, rtol=5e-3, atol=5e-4)
    for i, (a, b) in enumerate(zip(rgbs, rgbs_j)):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4,
                                   err_msg=f"rgb pyramid level {i}")


def test_generator_bf16_against_fp32_jax_oracle(jax_generator_run):
    params, latents, noises, out_j, _ = jax_generator_run
    out, _ = port_forward(params, latents, noises, amp=True)
    assert np.isfinite(out).all()
    assert rel_err(out, out_j) <= 0.08


def test_port_init_has_the_jax_distributions():
    # the port's own init: same per-leaf scale as flax's, leaf by leaf
    jg = JaxGenerator(**G_CONFIG, s2d_trunk=False)
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
            "latent": jax.random.PRNGKey(2)}
    jparams = jax.device_get(jg.init(keys, batch_size=1)["params"])
    gan = GigaGAN(generator=G_CONFIG, device="cpu", seed=0)
    state = gan.G.state_dict()
    converted = convert_params(jparams, gan.G)
    for key, want in converted.items():
        got = state[key]
        if float(want.std()) == 0.0:  # zeros / ones initializers
            assert torch.equal(got, want), key
            continue
        if want.numel() < 500:
            continue
        ratio = float(got.std() / want.std())
        assert 0.85 < ratio < 1.15, (key, ratio)
        assert abs(float(got.mean())) < 0.1 * float(want.std()) + 1e-3, key
