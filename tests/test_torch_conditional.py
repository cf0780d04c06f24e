"""The port's text-conditioned path against the JAX package on the CPU, at
the sizes of tests/test_clip.py's conditional tests (16px, the tiny CLIP):
the text layers, the conditional G and D (with the R1 double backward), the
vision-aided D and its penalty, whole d/g steps of ``TrainStepBuilder``
with and without accumulation (losses, per-leaf gradients, updated
params), ``generate(texts=...)``, ``save``/``load`` with the vision-aided D
and the mock-CLIP refusal.

Both sides run the same parameters (the weight bridge), the same CLIP
token encodings and embeddings, and the same random draws: JAX's are
numpy draws recorded while its step is traced, which the port receives as
``StepDraws`` (tests/test_torch_train.py).  Tolerances are those of
tests/test_torch_train.py: losses 1e-4 relative, each gradient leaf 1e-3
of its largest element, updated parameters 0.05 of a learning-rate step
from a mid-run Adam state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

torch = pytest.importorskip("torch")

from gigagan_tpu import losses as jlosses  # noqa: E402
from gigagan_tpu.models import clip as jclip  # noqa: E402
from gigagan_tpu.models import conditioning as jc  # noqa: E402
from gigagan_tpu.models import discriminator as jd  # noqa: E402
from gigagan_tpu.models import layers as jl  # noqa: E402
from gigagan_tpu.models.generator import Generator as JaxGenerator  # noqa: E402
from gigagan_tpu.models.vision_aided import (  # noqa: E402
    VisionAidedDiscriminator as JaxVD,
)
from gigagan_tpu.train.optimizer import (  # noqa: E402
    get_optimizer as jax_get_optimizer,
)
from gigagan_tpu.train.steps import GANState  # noqa: E402
from gigagan_tpu.train.steps import (  # noqa: E402
    TrainStepBuilder as JaxTrainStepBuilder,
)
from test_torch_models import feed_noise_torch  # noqa: E402
from test_torch_train import (  # noqa: E402
    ADAM_COUNT,
    BETAS,
    D_PIPELINE_DRAWS,
    LR,
    capture_tx,
    check_losses,
    grads_within,
    jax_adam_update,
    mid_run_nu,
    numpy_draws,
    params_within,
    port_draws,
    random_params,
)

from gigagan_tpu_torch import GigaGAN, ops  # noqa: E402
from gigagan_tpu_torch.convert import (  # noqa: E402
    convert_clip_params,
    convert_params,
)
from gigagan_tpu_torch.data import MockTextImageDataset  # noqa: E402
from gigagan_tpu_torch.models import clip as tclip  # noqa: E402
from gigagan_tpu_torch.models import conditioning as tc  # noqa: E402
from gigagan_tpu_torch.models import discriminator as td  # noqa: E402
from gigagan_tpu_torch.models import layers as tl  # noqa: E402
from gigagan_tpu_torch.models import vision_aided as tv  # noqa: E402
from gigagan_tpu_torch.ops.kernels.flash_attention_hv import (  # noqa: E402
    flash_hv_mode,
)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def in_tmp_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


TINY = dict(embed_dim=16, image_size=32, patch_size=8, vision_width=24,
            vision_layers=2, vision_heads=2, context_length=12,
            vocab_size=49408, text_width=16, text_layers=2, text_heads=2)
TE = dict(dim=16, depth=1, clip_dim=16)
G_CFG = dict(image_size=16, dim_capacity=4, dim_max=32, dim_latent=16,
             style_network=dict(dim=16, depth=1, dim_text_latent=16),
             text_encoder=TE, self_attn_resolutions=(),
             cross_attn_resolutions=(8,), num_conv_kernels=2,
             unconditional=False)
D_CFG = dict(image_size=16, dim_capacity=4, dim_max=32, attn_resolutions=(),
             multiscale_input_resolutions=(8,), num_conv_kernels=2,
             unconditional=False, text_encoder=TE)
VD_CFG = dict(clip_image_dim=24, clip_text_dim=16, layer_indices=(-1, -2),
              conv_dim=24, unconditional=False, num_conv_kernels=2)
DIFF_AUGMENT = dict(prob=1.0, horizontal_flip=True)
BATCH, ACCUM = 2, 2
CAPTIONS = ["a cat", "a dog on a mat", "red bird", "tall tree"]
# the draws of one G forward and its DiffAugment: the latent, two pixel
# noises per stage (3 stages at 16px), the flip's two uniforms
G_DRAWS = 1 + 2 * 3 + 2


# ------------------------------------------------------------ the models

@pytest.fixture(scope="module")
def setup():
    """The JAX and port CLIP adapters (the same parameters), the flax
    models with random parameters, and one batch of CLIP conditioning."""
    jax_clip = jclip.OpenClipAdapter(name=jclip.CLIPConfig(**TINY), seed=0)
    port_clip = tclip.OpenClipAdapter(name=tclip.CLIPConfig(**TINY),
                                      device="cpu")
    port_clip.model.load_state_dict(convert_clip_params(
        jax.device_get(jax_clip.params), port_clip.model))

    jg = JaxGenerator(**G_CFG, s2d_trunk=False)
    jdisc = jd.Discriminator(**D_CFG, s2d_trunk=False)
    jvd = JaxVD(**VD_CFG)
    embeds, enc = (np.asarray(a) for a in jax_clip.embed_texts(CAPTIONS))
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
            "latent": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}
    g_params = random_params(jax.eval_shape(lambda: jg.init(
        keys, text_encodings=jnp.asarray(enc[:1])))["params"], seed=10)
    images = jnp.zeros((1, 16, 16, 3))
    d_params = random_params(jax.eval_shape(lambda: jdisc.init(
        keys, images, jdisc.real_images_to_rgbs(images),
        text_encodings=jnp.asarray(enc[:1])))["params"], seed=11)
    _, taps = jax_clip.embed_images(jnp.zeros((1, 32, 32, 3)))
    vd_vars = jvd.init({"params": jax.random.PRNGKey(4)}, taps,
                       text_embeds=jnp.asarray(embeds[:1]))
    vd_params = random_params(jax.device_get(vd_vars["params"]), seed=12)
    vd_buffers = jax.device_get(vd_vars["buffers"])
    real = np.random.default_rng(13).random(
        (ACCUM * BATCH, 16, 16, 3)).astype(np.float32)
    return dict(jax_clip=jax_clip, port_clip=port_clip, jg=jg, jdisc=jdisc,
                jvd=jvd, g_params=g_params, d_params=d_params,
                vd_params=vd_params, vd_buffers=vd_buffers, real=real,
                enc=enc, embeds=embeds)


def test_port_adapter_embeds_as_jax(setup):
    embeds, enc = setup["port_clip"].embed_texts(CAPTIONS)
    np.testing.assert_allclose(enc.numpy(), setup["enc"], rtol=2e-4,
                               atol=5e-5)
    np.testing.assert_allclose(embeds.numpy(), setup["embeds"], rtol=2e-4,
                               atol=5e-5)


# ------------------------------------------------------------------ layers

B, N, C, D_CTX = 2, 7, 16, 12
TOKEN_MASK = np.array([[True] * 7, [True] * 4 + [False] * 3])
FMAP = np.random.default_rng(1).standard_normal((B, 4, 4, C)).astype(
    np.float32)
TOKENS = np.random.default_rng(2).standard_normal((B, N, C)).astype(
    np.float32)
CONTEXT = np.random.default_rng(3).standard_normal((B, N, D_CTX)).astype(
    np.float32)
ENCODINGS = np.where(TOKEN_MASK[..., None], CONTEXT, 0.0).astype(np.float32)

# name → (flax module, port module, numpy inputs, numpy keyword inputs)
LAYER_CASES = {
    "text_attention": (
        lambda: jl.TextAttention(C, dim_head=8, heads=2),
        lambda: tl.TextAttention(C, dim_head=8, heads=2),
        [TOKENS], dict(mask=TOKEN_MASK)),
    "cross_attention": (
        lambda: jl.CrossAttention(C, D_CTX, dim_head=8, heads=2),
        lambda: tl.CrossAttention(C, D_CTX, dim_head=8, heads=2),
        [FMAP, CONTEXT], dict(mask=TOKEN_MASK)),
    "cross_attention_block": (
        lambda: jl.CrossAttentionBlock(C, D_CTX, dim_head=8, heads=2,
                                       ff_mult=2),
        lambda: tl.CrossAttentionBlock(C, D_CTX, dim_head=8, heads=2,
                                       ff_mult=2),
        [FMAP, CONTEXT], dict(mask=TOKEN_MASK)),
    "transformer": (
        lambda: jl.Transformer(C, 2, dim_head=8, heads=2),
        lambda: tl.Transformer(C, 2, dim_head=8, heads=2),
        [TOKENS], dict(mask=TOKEN_MASK)),
    "text_encoder": (
        lambda: jc.TextEncoder(C, 2, clip_dim=D_CTX, dim_head=8, heads=2),
        lambda: tc.TextEncoder(C, 2, clip_dim=D_CTX, dim_head=8, heads=2),
        [ENCODINGS], {}),
    "text_encoder_same_dim": (
        lambda: jc.TextEncoder(C, 1, clip_dim=C),
        lambda: tc.TextEncoder(C, 1, clip_dim=C),
        [np.where(TOKEN_MASK[..., None], TOKENS, 0.0).astype(np.float32)],
        {}),
    "style_network_text": (
        lambda: jc.StyleNetwork(dim=C, depth=2, dim_text_latent=D_CTX),
        lambda: tc.StyleNetwork(dim=C, depth=2, dim_text_latent=D_CTX),
        [TOKENS[:, 0], CONTEXT[:, 0]], {}),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_text_layer_matches_flax(name):
    make_jax, make_torch, inputs, kwargs = LAYER_CASES[name]
    jmod = make_jax()
    jin = [jnp.asarray(a) for a in inputs]
    jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}
    params = random_params(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), *jin, **jkw))["params"], seed=4)
    want = jmod.apply({"params": params}, *jin, **jkw)
    tmod = make_torch()
    tmod.load_state_dict(convert_params(params, tmod))
    with torch.no_grad():
        got = tmod(*map(t, inputs), **{k: t(v) for k, v in kwargs.items()})
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g.dtype == torch.bool:  # the text encoder's any-nonzero mask
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert rel_err(g.numpy(), w) <= 1e-4, (name, rel_err(g, w))


def test_random_fixed_projection_is_a_frozen_buffer():
    jmod = jl.RandomFixedProjection(24)
    variables = jmod.init({"params": jax.random.PRNGKey(0)},
                          jnp.asarray(FMAP))
    want = jmod.apply(variables, jnp.asarray(FMAP))
    tmod = tl.RandomFixedProjection(C, 24)
    tmod.load_state_dict(convert_params({}, tmod,
                                        buffers=variables["buffers"]))
    assert not list(tmod.parameters())
    assert rel_err(tmod(t(FMAP)).numpy(), want) <= 1e-5
    # the port's own draw has the scale of JAX's (kaiming, fan_out, gain 1)
    tl.init_parameters(tmod, torch.Generator().manual_seed(0))
    ratio = float(tmod.fixed_weights.std()) / float(
        np.std(variables["buffers"]["fixed_weights"]))
    assert 0.85 < ratio < 1.15


# ------------------------------------------------------------- G, D and VD

def test_conditional_generator_matches_flax(setup):
    jg, g_params, enc = setup["jg"], setup["g_params"], setup["enc"][:3]
    rng = np.random.default_rng(5)
    latents = rng.standard_normal((3, 16)).astype(np.float32)
    noises = []

    def interceptor(next_fun, args, kwargs, context):
        if (isinstance(context.module, jl.Noise)
                and context.method_name == "__call__"):
            n = rng.standard_normal((*args[0].shape[:-1], 1)).astype(
                np.float32)
            noises.append(n)
            kwargs = dict(kwargs, noise=jnp.asarray(n))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(interceptor):
        out_j, rgbs_j = jg.apply({"params": g_params},
                                 text_encodings=jnp.asarray(enc),
                                 noise=jnp.asarray(latents),
                                 return_all_rgbs=True)
    gen = GigaGAN(generator=G_CFG, device="cpu", seed=0)
    gen.load_jax_params(g_params)
    assert gen.G.stages[1].cross_attn is not None
    hooks = feed_noise_torch(gen.G, noises)
    with torch.no_grad():
        out, rgbs = gen.G(text_encodings=t(enc), noise=t(latents),
                          return_all_rgbs=True)
    for h in hooks:
        h.remove()
    assert rel_err(out.numpy(), out_j) <= 1e-4
    for a, b in zip(rgbs, rgbs_j):
        assert rel_err(a.numpy(), b) <= 1e-4


def jax_d_loss(jdisc, images, rgbs, text):
    """Σ logits + Σ multiscale logits and its R1: the D value whose
    parameter gradient, double backward included, the test compares."""

    def outputs(p, x):
        lg, ms, _ = jdisc.apply({"params": p}, x, jdisc.real_images_to_rgbs(
            x), text_encodings=text, calc_aux_loss=False)
        return lg.sum() + sum(m.sum() for m in ms), lg

    def loss(p, x):
        out, lg = outputs(p, x)
        g = jax.grad(lambda x_: outputs(p, x_)[0])(x)
        return out + jnp.sum(g * g), lg

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def test_conditional_discriminator_and_its_r1_match_flax(setup):
    jdisc, d_params = setup["jdisc"], setup["d_params"]
    images = setup["real"][:3]
    enc = setup["enc"][:3]
    (loss_j, lg_j), grads_j = jax_d_loss(jdisc, None, None, jnp.asarray(
        enc))(d_params, jnp.asarray(images))

    disc = td.Discriminator(**D_CFG)
    disc.load_state_dict(convert_params(d_params, disc))
    x = t(images).requires_grad_()
    lg, ms, _ = disc(x, disc.real_images_to_rgbs(x), t(enc),
                     calc_aux_loss=False)
    # one predictor, at 4x4, on the rows of both scale groups
    assert len(ms) == 1 and ms[0].shape[:3] == (6, 4, 4)
    out = lg.sum() + sum(m.sum() for m in ms)
    (g,) = torch.autograd.grad(out, x, create_graph=True)
    loss = out + (g * g).sum()
    loss.backward()
    assert rel_err(lg.detach().numpy(), lg_j) <= 1e-4
    assert rel_err(loss.item(), float(loss_j)) <= 1e-4
    want = convert_params(grads_j, disc)
    for name, p in disc.named_parameters():
        if p.grad is None:  # the reconstruction decoder, not run here
            assert "recon_decoder" in name and not want[name].any(), name
            continue
        assert rel_err(p.grad.numpy(), want[name].numpy()) <= 1e-3, name

    # the text embedding given directly (text_dim) takes the same heads
    disc_e = td.Discriminator(**{**D_CFG, "text_encoder": None,
                                 "text_dim": 16})
    assert disc_e.text_enc is None
    with torch.no_grad():
        lg_e, _, _ = disc_e(t(images), disc_e.real_images_to_rgbs(t(images)),
                            text_embeds=t(setup["embeds"][:3]),
                            calc_aux_loss=False)
    assert lg_e.shape == lg.shape


def test_vision_aided_d_and_its_penalty_match_flax(setup):
    jvd, vd_params, vd_buffers = (setup[k] for k in ("jvd", "vd_params",
                                                     "vd_buffers"))
    images = setup["real"][:3]
    embeds = jnp.asarray(setup["embeds"][:3])
    _, taps = setup["jax_clip"].embed_images(jnp.asarray(images))
    w = 0.5

    def loss(p, tp):
        def run(tp_):
            return jvd.apply({"params": p, "buffers": vd_buffers}, tp_,
                             text_embeds=embeds)

        logits, vjp = jax.vjp(run, tp)
        (g,) = vjp([jnp.ones_like(lg) * w for lg in logits])
        g = jnp.moveaxis(g, 1, 0).reshape(g.shape[1], -1)
        gp = 10.0 * jnp.mean(jnp.sum(g * g, axis=1) + 1e-12)
        return sum(lg.mean() for lg in logits) + gp, (logits, gp)

    (_, (logits_j, gp_j)), grads_j = jax.value_and_grad(
        loss, has_aux=True)(vd_params, taps)

    vd = tv.VisionAidedDiscriminator(**VD_CFG)
    vd.load_state_dict(convert_params(vd_params, vd, buffers=vd_buffers))
    taps_t = setup["port_clip"].embed_images(t(images))[1]
    np.testing.assert_allclose(taps_t.numpy(), taps, rtol=2e-4, atol=5e-5)
    taps_t = taps_t.detach().requires_grad_()
    logits = vd(taps_t, t(setup["embeds"][:3]))
    (g,) = torch.autograd.grad(logits, taps_t,
                               [torch.ones_like(lg) * w for lg in logits],
                               create_graph=True)
    from gigagan_tpu_torch.losses import sample_sq_norms

    gp = 10.0 * sample_sq_norms(g.movedim(1, 0)).mean()
    (sum(lg.mean() for lg in logits) + gp).backward()
    assert [lg.shape for lg in logits] == [(3, 4, 4)] * 2
    for a, b in zip(logits, logits_j):
        assert rel_err(a.detach().numpy(), b) <= 1e-4
    assert rel_err(gp.item(), float(gp_j)) <= 1e-4
    want = convert_params(grads_j, vd, buffers=vd_buffers)
    for name, p in vd.named_parameters():
        assert rel_err(p.grad.numpy(), want[name].numpy()) <= 1e-3, name


# ------------------------------------------------------------ train steps

def jax_builder(setup, **kwargs):
    tx = jax_get_optimizer(lr=LR, wd=0.0, betas=BETAS)
    return JaxTrainStepBuilder(
        setup["jg"], setup["jdisc"], tx, tx,
        vision_aided_discriminator=setup["jvd"], vd_tx=tx,
        clip=setup["jax_clip"],
        diff_augment=jlosses.DiffAugment(**DIFF_AUGMENT), **kwargs), tx


def port_gan(setup, **kwargs):
    kwargs.setdefault("seed", 0)
    gan = GigaGAN(generator=G_CFG, discriminator=D_CFG,
                  vision_aided_discriminator=VD_CFG, clip=setup["port_clip"],
                  allow_mock_clip=True, diff_augment=DIFF_AUGMENT,
                  learning_rate=LR, betas=BETAS, device="cpu", **kwargs)
    gan.load_jax_params(setup["g_params"], d_params=setup["d_params"],
                        vd_params=setup["vd_params"],
                        vd_buffers=setup["vd_buffers"])
    return gan


def seed_adam(opt, module, grads, buffers=None):
    """The mid-run Adam state (count 10, first moment 0, second moment the
    square of the leaf's largest gradient)."""
    nu = convert_params(mid_run_nu(grads), module, buffers=buffers)
    for name, p in module.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(ADAM_COUNT)),
                        "exp_avg": torch.zeros_like(p),
                        "exp_avg_sq": nu[name].clone()}


def check_module(module, tree, what, check, buffers=None):
    want = convert_params(tree, module, buffers=buffers)
    for name, p in module.named_parameters():
        check(name, p, want[name].numpy(), what)


def batch(setup, accum):
    """The step's batch as JAX's (accum, mb, ...) dict."""
    n = accum * BATCH
    shape = (accum, BATCH)
    return {"real_images": setup["real"][:n].reshape(*shape, 16, 16, 3),
            "text_encodings": setup["enc"][:n].reshape(*shape, 12, 16),
            "text_embeds": setup["embeds"][:n].reshape(*shape, 16)}


D_NAMES = ["divergence", "multiscale_divergence", "aux_reconstruction",
           "vision_aided_divergence", "matching_aware_loss"]
D_CASES = [(False, {}), (True, {}), (True, dict(gp_fwd_over_rev=True)),
           (True, dict(gp_chunk=1))]
D_IDS = ["no_r1", "r1", "r1_fwd_over_rev", "r1_gp_chunk"]


@pytest.mark.parametrize("accum", [1, ACCUM], ids=["accum1", "accum2"])
@pytest.mark.parametrize("apply_gp,options", D_CASES, ids=D_IDS)
def test_conditional_d_step_matches_jax(setup, apply_gp, options, accum):
    builder, tx = jax_builder(setup, **options)
    step_batch = batch(setup, accum)
    replay = D_PIPELINE_DRAWS if options.get("gp_fwd_over_rev") else None
    seed = 70 + 2 * len(D_IDS) * (accum - 1) + D_CASES.index(
        (apply_gp, options))
    if accum == 1:
        b0 = {k: v[0] for k, v in step_batch.items()}
        rolled = np.roll(b0["text_encodings"], 1, axis=0)
        fn = jax.jit(jax.value_and_grad(
            lambda tr, key: builder._d_micro_loss(
                tr, setup["g_params"], setup["vd_buffers"],
                {"clip": setup["jax_clip"].params}, b0["real_images"],
                b0["text_encodings"], b0["text_embeds"], rolled, key,
                apply_gp=apply_gp, calc_ms=True),
            has_aux=True))
        with numpy_draws(seed, replay=replay) as record:
            (_, metrics), grads = fn({"d": setup["d_params"],
                                      "vd": setup["vd_params"]},
                                     jax.random.PRNGKey(4))
        grads_d, grads_vd = grads["d"], grads["vd"]
    else:
        cap = capture_tx()
        builder.d_tx = builder.vd_tx = cap
        state = GANState(
            g_params=setup["g_params"], d_params=setup["d_params"],
            g_opt=None, d_opt=cap.init(setup["d_params"]), ema=None,
            steps=jnp.asarray(1, jnp.int32), vd_params=setup["vd_params"],
            vd_buffers=setup["vd_buffers"],
            vd_opt=cap.init(setup["vd_params"]))
        fn = builder.d_step_fn(grad_accum_every=accum, apply_gp=apply_gp,
                               calc_ms=True)
        with numpy_draws(seed, replay=replay) as record:
            new_state, metrics = fn(state, step_batch, jax.random.PRNGKey(4),
                                    {"clip": setup["jax_clip"].params})
        grads_d, grads_vd = new_state.d_opt, new_state.vd_opt
    new_d = jax_adam_update(tx, grads_d, setup["d_params"])
    new_vd = jax_adam_update(tx, grads_vd, setup["vd_params"])

    gan = port_gan(setup, **options)
    seed_adam(gan.d_opt, gan.D, grads_d)
    seed_adam(gan.vd_opt, gan.VD, grads_vd, buffers=setup["vd_buffers"])
    got = gan.train_discriminator_step(
        step_batch, grad_accum_every=accum, apply_gradient_penalty=apply_gp,
        calc_multiscale_loss=True, draws=[port_draws(record)] * accum)
    check_losses(got, metrics, D_NAMES + (["gradient_penalty"]
                                          if apply_gp else []))
    assert all(float(got[k]) != 0.0 for k in D_NAMES)
    check_module(gan.D, grads_d, "d grads", grads_within)
    check_module(gan.VD, grads_vd, "vd grads", grads_within,
                 setup["vd_buffers"])
    check_module(gan.D, new_d, "d params", params_within)
    check_module(gan.VD, new_vd, "vd params", params_within,
                 setup["vd_buffers"])


@pytest.mark.parametrize("accum", [1, ACCUM], ids=["accum1", "accum2"])
def test_conditional_g_step_matches_jax(setup, accum):
    builder, tx = jax_builder(setup)
    step_batch = batch(setup, accum)
    frozen = {"clip": setup["jax_clip"].params}
    if accum == 1:
        b0 = {k: v[0] for k, v in step_batch.items()}
        fn = jax.jit(jax.value_and_grad(
            lambda g, key: builder._g_micro_loss(
                g, setup["d_params"], setup["vd_params"],
                setup["vd_buffers"], frozen, b0["real_images"],
                b0["text_encodings"], b0["text_embeds"], key, calc_ms=True),
            has_aux=True))
        with numpy_draws(90) as record:
            (_, metrics), grads = fn(setup["g_params"],
                                     jax.random.PRNGKey(5))
    else:
        # the contrastive pool's forward-only pass and the step draw the
        # same fakes (the same keys): the first G_DRAWS draws repeat
        cap = capture_tx()
        builder.g_tx = cap
        state = GANState(
            g_params=setup["g_params"], d_params=setup["d_params"],
            g_opt=cap.init(setup["g_params"]), d_opt=None, ema=None,
            steps=jnp.asarray(1, jnp.int32), vd_params=setup["vd_params"],
            vd_buffers=setup["vd_buffers"], vd_opt=None)
        fn = builder.g_step_fn(grad_accum_every=accum, calc_ms=True)
        with numpy_draws(91, period=G_DRAWS) as record:
            new_state, metrics = fn(state, step_batch, jax.random.PRNGKey(5),
                                    frozen)
        grads = new_state.g_opt
        assert len(record) == G_DRAWS
    new_params = jax_adam_update(tx, grads, setup["g_params"])

    gan = port_gan(setup)
    seed_adam(gan.g_opt, gan.G, grads)
    got = gan.train_generator_step(step_batch, grad_accum_every=accum,
                                   calc_multiscale_loss=True,
                                   draws=[port_draws(record)] * accum)
    names = ["divergence", "multiscale_divergence", "total_vd_divergence",
             "contrastive_loss"]
    check_losses(got, metrics, names)
    assert all(float(got[k]) != 0.0 for k in names)
    check_module(gan.G, grads, "g grads", grads_within)
    check_module(gan.G, new_params, "g params", params_within)
    assert all(p.grad is None for p in gan.D.parameters())
    assert all(p.grad is None for p in gan.VD.parameters())


def test_contrastive_pool_replays_the_steps_draws(setup):
    # without explicit draws the pool pass and the step must draw the same
    # fakes: the pooled loss then equals the InfoNCE over the step's fakes,
    # whatever the seed
    gan = port_gan(setup, generator_contrastive_loss_weight=1.0)
    step_batch = batch(setup, ACCUM)
    seen = []
    embed_images = gan.clip.embed_images

    def spy(images):
        out = embed_images(images)
        seen.append(out[0].detach())
        return out

    gan.clip.embed_images = spy
    try:
        got = gan.train_generator_step(step_batch, grad_accum_every=ACCUM,
                                       calc_multiscale_loss=False, seed=3)
    finally:
        del gan.clip.embed_images
    pool, step = torch.cat(seen[:ACCUM]), torch.cat(seen[ACCUM:])
    assert pool.shape[0] == ACCUM * BATCH
    torch.testing.assert_close(pool, step, rtol=0, atol=0)
    from gigagan_tpu_torch.losses import clip_contrastive_loss

    np.testing.assert_allclose(
        float(got["contrastive_loss"]),
        float(clip_contrastive_loss(pool, t(step_batch["text_embeds"]
                                            ).reshape(-1, 16),
                                    gan.clip.logit_scale)), rtol=1e-6)


def test_matching_and_contrastive_need_two_samples(setup):
    gan = port_gan(setup)
    one = {k: v[:, :1] for k, v in batch(setup, 1).items()}
    with pytest.raises(AssertionError, match="matching-aware"):
        gan.train_discriminator_step(one, apply_gradient_penalty=False,
                                     calc_multiscale_loss=False)
    with pytest.raises(AssertionError, match="contrastive"):
        gan.train_generator_step(one, calc_multiscale_loss=False)


def test_adaptive_conv_takes_the_unfused_conv_inside_the_jvp():
    # the conditional predictors' convs inside the forward-over-reverse
    # surrogate: K1's autograd Function has no jvp, so under
    # flash_hv_mode() the conv takes its unfused path (as JAX takes XLA's
    # conv there); outside it, the jvp through the Function raises
    rng = np.random.default_rng(6)
    x, tx_ = (t(rng.standard_normal((2, 5, 5, 8)).astype(np.float32))
              for _ in range(2))
    w = t(rng.standard_normal((2, 3, 3, 8, 6)).astype(np.float32) * 0.2)
    mod, kmod = (t(rng.standard_normal(s).astype(np.float32))
                 for s in ((2, 8), (2, 2)))

    def conv(x_):
        return ops.adaptive_conv(x_, w, mod, kmod)

    def ref(x_):
        return ops.adaptive_conv_reference(x_, w, mod, kmod)

    with pytest.raises(RuntimeError):
        torch.func.jvp(conv, (x,), (tx_,))
    with flash_hv_mode():
        out, tangent = torch.func.jvp(conv, (x,), (tx_,))
    want_out, want_tangent = torch.func.jvp(ref, (x,), (tx_,))
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(tangent, want_tangent, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- trainer surface

def test_generate_from_texts_matches_flax(setup):
    jg, g_params = setup["jg"], setup["g_params"]
    gan = GigaGAN(generator=G_CFG, device="cpu", seed=0,
                  clip=setup["port_clip"], allow_mock_clip=True)
    gan.load_jax_params(g_params)
    for texts in (CAPTIONS[:1], CAPTIONS):
        rng = np.random.default_rng(len(texts))
        latents = rng.standard_normal((len(texts), 16)).astype(np.float32)
        noises = []

        def interceptor(next_fun, args, kwargs, context):
            if (isinstance(context.module, jl.Noise)
                    and context.method_name == "__call__"):
                n = rng.standard_normal((*args[0].shape[:-1], 1)).astype(
                    np.float32)
                noises.append(n)
                kwargs = dict(kwargs, noise=jnp.asarray(n))
            return next_fun(*args, **kwargs)

        _, enc = setup["jax_clip"].embed_texts(texts)
        with nn.intercept_methods(interceptor):
            want = jg.apply({"params": g_params}, text_encodings=enc,
                            noise=jnp.asarray(latents))
        hooks = feed_noise_torch(gan.G_ema, noises)
        got = gan.generate(texts=texts, noise=latents)
        for h in hooks:
            h.remove()
        assert got.shape == (len(texts), 16, 16, 3)
        assert rel_err(got, want) <= 1e-4
    # drawn latents: one sample per caption
    assert gan.generate(texts=CAPTIONS[:3], seed=1).shape[0] == 3


def test_train_save_and_load_with_the_vision_aided_d(setup, tmp_path):
    gan = port_gan(setup, log_steps_every=1, num_samples=4,
                   apply_gradient_penalty_every=2)
    gan.set_dataloader(MockTextImageDataset(16, length=8).get_dataloader(2))
    log = gan.train(2)
    assert [r["step"] for r in log] == [1, 2]
    assert log[1]["d_gradient_penalty"] > 0
    for key in ("d_vision_aided_divergence", "d_matching_aware_loss",
                "g_total_vd_divergence", "g_contrastive_loss"):
        assert all(np.isfinite(r[key]) and r[key] != 0 for r in log), key
    assert sorted(p.name for p in (tmp_path / "gigagan-results").glob(
        "*.png")) == ["ema-sample-0.png", "sample-0.png"]

    path = tmp_path / "ckpt.pt"
    gan.save(path)
    saved = torch.load(path, weights_only=True)
    assert {"VD", "vd_opt"} <= set(saved)
    assert not any("clip" in k.lower() for k in saved)
    other = port_gan(setup, seed=1)
    for p in other.VD.parameters():
        p.data.add_(1.0)
    other.load(path, strict=True)
    for a, b in zip(gan.VD.state_dict().values(),
                    other.VD.state_dict().values()):
        assert torch.equal(a, b)
    assert other.vd_opt.state_dict()["state"].keys() == \
        gan.vd_opt.state_dict()["state"].keys()
    for i, s in gan.vd_opt.state_dict()["state"].items():
        assert torch.equal(s["exp_avg"],
                           other.vd_opt.state_dict()["state"][i]["exp_avg"])
    assert other.steps == gan.steps == 3


def test_mock_clip_is_refused_without_opt_in(setup, capsys):
    kwargs = dict(generator=G_CFG, discriminator=D_CFG, clip=setup[
        "port_clip"], device="cpu")
    assert setup["port_clip"].mock_reasons
    with pytest.raises(ValueError, match="mock"):
        GigaGAN(**kwargs)
    GigaGAN(**kwargs, allow_mock_clip=True)
    assert "MOCK" in capsys.readouterr().out
    # unconditional training never looks at the CLIP
    GigaGAN(generator=dict(G_CFG, style_network=dict(dim=16, depth=1),
                           text_encoder=None, unconditional=True),
            discriminator=dict(D_CFG, text_encoder=None,
                               unconditional=True),
            clip=setup["port_clip"], device="cpu")
    # a vision-aided D needs a CLIP
    with pytest.raises(AssertionError, match="CLIP adapter"):
        GigaGAN(generator=G_CFG, discriminator=D_CFG,
                vision_aided_discriminator=VD_CFG, device="cpu")
