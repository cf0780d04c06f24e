"""The port's ``train_upsampler`` steps against the JAX package's on the
CPU, at tests/test_upsampler.py's small sizes (dim 8, 8 → 32,
``dim_mults=(1, 2)``) with tests/test_torch_train.py's 32px D: a d_step
without R1, with R1 reverse-over-reverse and forward-over-reverse, and a
g_step, from one mid-run state.  G is fed the reals resized to 8 by
'nearest', as JAX's ``_generate`` does.  JAX's draws are numpy draws
recorded while its step is traced, which the port receives as
``StepDraws`` (tests/test_torch_train.py).  Tolerances are
tests/test_torch_train.py's: losses 1e-4 relative, each gradient leaf
1e-3 of its largest element, updated parameters 0.05 of a learning-rate
step from a mid-run Adam state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu import losses as jlosses  # noqa: E402
from gigagan_tpu.models.discriminator import (  # noqa: E402
    Discriminator as JaxDiscriminator,
)
from gigagan_tpu.models.unet_upsampler import (  # noqa: E402
    UnetUpsampler as JaxUpsampler,
)
from gigagan_tpu.train.optimizer import (  # noqa: E402
    get_optimizer as jax_get_optimizer,
)
from gigagan_tpu.train.steps import (  # noqa: E402
    TrainStepBuilder as JaxTrainStepBuilder,
)
from test_torch_train import (  # noqa: E402
    BETAS,
    D_PIPELINE_DRAWS,
    DIFF_AUGMENT,
    LR,
    check_leaves,
    check_losses,
    grads_within,
    jax_adam_update,
    numpy_draws,
    params_within,
    port_draws,
    random_params,
    seed_adam_state,
)
from test_torch_upsampler import BATCH, KEYS, SMALL, UP_D  # noqa: E402

from gigagan_tpu_torch import GigaGAN  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_setup():
    jm = JaxUpsampler(**SMALL)
    jdisc = JaxDiscriminator(**UP_D, s2d_trunk=False)
    g_params = random_params(jax.eval_shape(lambda: jm.init(
        KEYS, jnp.zeros((1, 8, 8, 3))))["params"], seed=50)
    images = jnp.zeros((1, 32, 32, 3))
    d_params = random_params(jax.eval_shape(lambda: jdisc.init(
        KEYS, images, jdisc.real_images_to_rgbs(images)))["params"], seed=51)
    tx = jax_get_optimizer(lr=LR, wd=0.0, betas=BETAS)
    real = np.random.default_rng(52).random((BATCH, 32, 32, 3)).astype(
        np.float32)
    return jm, jdisc, tx, g_params, d_params, real


def jax_builder(jm, jdisc, tx, **kw):
    return JaxTrainStepBuilder(
        jm, jdisc, tx, tx, diff_augment=jlosses.DiffAugment(**DIFF_AUGMENT),
        train_upsampler=True, input_image_size=8, **kw)


def port_gan(g_params, d_params, **kw):
    gan = GigaGAN(generator=SMALL, discriminator=UP_D,
                  diff_augment=DIFF_AUGMENT, learning_rate=LR, betas=BETAS,
                  train_upsampler=True, device="cpu", seed=0, **kw)
    gan.load_jax_params(g_params, d_params=d_params)
    return gan


@pytest.mark.parametrize("apply_gp,fwd_over_rev",
                         [(False, False), (True, False), (True, True)],
                         ids=["no_r1", "r1", "r1_fwd_over_rev"])
def test_upsampler_d_step_matches_jax(jax_setup, apply_gp, fwd_over_rev):
    jm, jdisc, tx, g_params, d_params, real = jax_setup
    builder = jax_builder(jm, jdisc, tx, gp_fwd_over_rev=fwd_over_rev)
    fn = jax.jit(jax.value_and_grad(
        lambda d, key: builder._d_micro_loss(
            {"d": d}, g_params, None, {}, real, None, None, None, key,
            apply_gp=apply_gp, calc_ms=True),
        has_aux=True))
    with numpy_draws(60 + apply_gp, replay=D_PIPELINE_DRAWS
                     if fwd_over_rev else None) as record:
        (_, metrics), grads = fn(d_params, jax.random.PRNGKey(4))
    new_params = jax_adam_update(tx, grads, d_params)

    gan = port_gan(g_params, d_params, gp_fwd_over_rev=fwd_over_rev)
    seed_adam_state(gan.d_opt, gan.D, grads)
    got = gan.train_discriminator_step(
        real, apply_gradient_penalty=apply_gp, calc_multiscale_loss=True,
        draws=port_draws(record))
    names = ["divergence", "multiscale_divergence", "aux_reconstruction"]
    check_losses(got, metrics, names + (["gradient_penalty"]
                                        if apply_gp else []))
    check_leaves(gan.D, grads, "d grads", grads_within)
    check_leaves(gan.D, new_params, "d params", params_within)


def test_upsampler_g_step_matches_jax(jax_setup):
    jm, jdisc, tx, g_params, d_params, real = jax_setup
    builder = jax_builder(jm, jdisc, tx)
    fn = jax.jit(jax.value_and_grad(
        lambda g, key: builder._g_micro_loss(
            g, d_params, None, None, {}, real, None, None, key,
            calc_ms=True),
        has_aux=True))
    with numpy_draws(70) as record:
        (_, metrics), grads = fn(g_params, jax.random.PRNGKey(5))
    new_params = jax_adam_update(tx, grads, g_params)

    gan = port_gan(g_params, d_params)
    seed_adam_state(gan.g_opt, gan.G, grads)
    got = gan.train_generator_step(real, calc_multiscale_loss=True,
                                   draws=port_draws(record))
    check_losses(got, metrics, ["divergence", "multiscale_divergence"])
    check_leaves(gan.G, grads, "g grads", grads_within)
    check_leaves(gan.G, new_params, "g params", params_within)
    assert all(p.grad is None for p in gan.D.parameters())
