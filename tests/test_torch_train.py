"""The PyTorch port's unconditional training pieces against the JAX
package on the CPU: losses, DiffAugment, the optimizer, the EMA schedule,
the mock data, and whole d/g steps of ``TrainStepBuilder`` at 32px from one
state.  Every random draw of a JAX step (latents, pixel noise, the
DiffAugment flips, the decoder's dropout mask and patch scores) is a numpy
draw that the port receives explicitly.

The state is a mid-run one: both optimizers start from the same Adam
moments (count 10, first moment 0, second moment the square of the
leaf's largest gradient).  From a fresh state Adam's first update is
lr·sign(g), so a gradient element near zero whose fp32 rounding differs
between the frameworks would flip a whole lr-sized step."""

import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu import losses as jlosses  # noqa: E402
from gigagan_tpu.data.datasets import (  # noqa: E402
    MockImageDataset as JaxMockImageDataset,
)
from gigagan_tpu.models.discriminator import (  # noqa: E402
    Discriminator as JaxDiscriminator,
)
from gigagan_tpu.models.generator import Generator as JaxGenerator  # noqa: E402
from gigagan_tpu.train.ema import EMAState, ema_update  # noqa: E402
from gigagan_tpu.train.optimizer import (  # noqa: E402
    get_optimizer as jax_get_optimizer,
)
from gigagan_tpu.train.steps import (  # noqa: E402
    TrainStepBuilder as JaxTrainStepBuilder,
)

from gigagan_tpu_torch import GigaGAN, losses  # noqa: E402
from gigagan_tpu_torch.convert import convert_params  # noqa: E402
from gigagan_tpu_torch.data import MockImageDataset  # noqa: E402
from gigagan_tpu_torch.ops.kernels import plain_reference  # noqa: E402
from gigagan_tpu_torch.train.ema import EMA  # noqa: E402
from gigagan_tpu_torch.train.optimizer import get_optimizer  # noqa: E402
from gigagan_tpu_torch.train.steps import StepDraws  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tier-1 run puts several test processes on the cores; a torch
    thread pool per process would only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def in_tmp_dir(tmp_path, monkeypatch):
    """train() saves sample grids and a checkpoint at its first step, into
    ./gigagan-results and ./gigagan-models by default: not into the
    checkout the tests run from."""
    monkeypatch.chdir(tmp_path)


def random_params(shapes, seed):
    """Random values at the scale of each leaf's initializer."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            std = np.sqrt(2.0 / np.prod(shape[:-1]))
        elif name == "weights":
            std = np.sqrt(2.0 / np.prod(shape[1:-1]))
        elif name == "gamma":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif name in ("null_kv", "weight") and len(shape) != 1:
            std = 1.0  # null key/value, EqualLinear
        elif name == "init_block":
            std = 0.5
        else:
            std = 0.1
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@contextlib.contextmanager
def numpy_draws(seed, replay=None, period=None):
    """jax.random.{normal, uniform, bernoulli} → numpy draws of the
    requested shape, recorded in call order (constants under jit).

    ``replay=n``: the discriminator pipeline's n draws (from the real-side
    DiffAugment flip, the third scalar uniform, on) repeat in every later
    run of the pipeline, as the same keys repeat them in JAX (the
    forward-over-reverse step runs it three times); only the first run's
    draws are recorded.  ``period=n``: the first n draws repeat from then
    on, as the accumulated g_step's contrastive pool pass and its step
    draw the same fakes from the same keys."""
    rng = np.random.default_rng(seed)
    record = []
    calls = []  # (kind, shape) of every draw, replays included
    orig = (jax.random.normal, jax.random.uniform, jax.random.bernoulli)
    real_sites = ("models/generator.py", "models/layers.py",
                  "models/discriminator.py", "models/unet_upsampler.py",
                  "gigagan_tpu/losses.py")

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

    def drawn(kind, shape, fresh):
        if period is not None and len(calls) >= period:
            k, a = record[len(calls) % period]
            assert (k, a.shape) == (kind, tuple(shape)), (k, kind)
            calls.append((kind, tuple(shape)))
            return a
        if replay is not None:
            scalar_u = [i for i, c in enumerate(calls)
                        if c == ("uniform", ())]
            if len(scalar_u) >= 3 and len(calls) >= scalar_u[2] + replay:
                start = scalar_u[2]
                k, a = record[start + (len(calls) - start) % replay]
                assert (k, a.shape) == (kind, tuple(shape)), (k, kind)
                calls.append((kind, tuple(shape)))
                return a
        calls.append((kind, tuple(shape)))
        a = fresh()
        record.append((kind, a))
        return a

    @from_model
    def normal(key, shape=(), dtype=jnp.float32):
        a = drawn("normal", shape, lambda: rng.standard_normal(
            tuple(shape)).astype(np.float32))
        return jnp.asarray(a, dtype)

    @from_model
    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        a = drawn("uniform", shape,
                  lambda: rng.random(tuple(shape)).astype(np.float32))
        return jnp.asarray(a, dtype)

    @from_model
    def bernoulli(key, p=0.5, shape=None):
        a = drawn("bernoulli", shape, lambda: rng.random(tuple(shape)) < p)
        return jnp.asarray(a)

    jax.random.normal, jax.random.uniform, jax.random.bernoulli = (
        normal, uniform, bernoulli)
    try:
        yield record
    finally:
        jax.random.normal, jax.random.uniform, jax.random.bernoulli = orig


def port_draws(record, patches_kept=1):
    """The recorded JAX draws of one step as the port's StepDraws: the
    first normal is the latent, the others the pixel noise; scalar uniform
    pairs are the DiffAugment draws (fake, then real); the decoder's
    bernoulli is its keep mask and its uniform its patch scores."""
    normals = [a for k, a in record if k == "normal"]
    flips = [bool(a < 0.5) for k, a in record
             if k == "uniform" and a.ndim == 0][1::2]
    keeps = [t(a) for k, a in record if k == "bernoulli"]
    scores = [a for k, a in record if k == "uniform" and a.ndim == 2]
    recon = [(keep, t(np.argsort(s, axis=-1, kind="stable")
                      [:, :patches_kept]))
             for keep, s in zip(keeps, scores)]
    return StepDraws(
        latents=t(normals[0]), pixel_noise=[t(n) for n in normals[1:]],
        fake_flip=flips[0], real_flip=flips[1] if len(flips) > 1 else None,
        recon=recon or None,
    )


# ------------------------------------------------------------------ losses

def test_hinge_losses_match_jax():
    rng = np.random.default_rng(0)
    real, fake = (rng.standard_normal((3, 5)).astype(np.float32)
                  for _ in range(2))
    np.testing.assert_allclose(
        losses.discriminator_hinge_loss(t(real), t(fake)).numpy(),
        jlosses.discriminator_hinge_loss(real, fake), rtol=1e-6)
    np.testing.assert_allclose(losses.generator_hinge_loss(t(fake)).numpy(),
                               jlosses.generator_hinge_loss(fake), rtol=1e-6)


def test_gradient_penalty_oracle_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    w = rng.standard_normal((4, 4, 2)).astype(np.float32)

    def jfn(i):
        return jnp.sum(jnp.tanh(i * w) * 2.0)

    def tfn(i):
        return (torch.tanh(i * t(w)) * 2.0).sum()

    want = jlosses.gradient_penalty(jnp.asarray(x), jfn)
    np.testing.assert_allclose(
        losses.gradient_penalty(t(x), tfn).detach().numpy(), want,
        rtol=1e-5)


@pytest.mark.parametrize("flip", [False, True])
def test_diff_augment_flips_image_and_rgbs_alike(flip):
    rng = np.random.default_rng(2)
    img = t(rng.standard_normal((2, 8, 8, 3)).astype(np.float32))
    rgbs = [t(rng.standard_normal((2, s, s, 3)).astype(np.float32))
            for s in (4, 2)]
    aug = losses.DiffAugment(prob=1.0, horizontal_flip=True)
    out, out_rgbs = aug(img, rgbs, flip=flip)
    for a, b in zip([out, *out_rgbs], [img, *rgbs]):
        assert torch.equal(a, b.flip(2) if flip else b)
    never = losses.DiffAugment(prob=0.0, horizontal_flip=True)
    gen = torch.Generator().manual_seed(0)
    assert not any(never.draw(gen) for _ in range(20))
    flips = [aug.draw(gen) for _ in range(200)]
    assert 60 < sum(flips) < 140


def test_mock_dataset_gives_the_jax_pixels():
    ours, theirs = MockImageDataset(16, seed=3), JaxMockImageDataset(16, seed=3)
    for i in (0, 7):
        np.testing.assert_array_equal(ours[i], theirs[i])
    batches = list(MockImageDataset(8, length=10).get_dataloader(4))
    assert len(batches) == 2 and batches[0].shape == (4, 8, 8, 3)


# --------------------------------------------------------- optimizer, EMA

@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_optimizer_matches_optax(wd):
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((4,)).astype(np.float32)}
    tx = jax_get_optimizer(lr=2e-3, wd=wd, betas=(0.5, 0.9))
    state = tx.init(params)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    opt = get_optimizer(tp.values(), lr=2e-3, wd=wd, betas=(0.5, 0.9))
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tp.items():
            p.grad = t(grads[k])
        opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), params[k], rtol=1e-5,
                                   atol=1e-6)


def test_ema_schedule_matches_jax():
    rng = np.random.default_rng(5)
    init = rng.standard_normal((6,)).astype(np.float32)
    kw = dict(beta=0.9, update_every=3, update_after_step=4)
    state = EMAState.create({"p": jnp.asarray(init)})
    model, ema_model = (torch.nn.Linear(1, 6, bias=False) for _ in range(2))
    for m in (model, ema_model):
        with torch.no_grad():
            m.weight.copy_(t(init)[:, None])
    ema = EMA(ema_model, **kw)
    for _ in range(14):
        new = rng.standard_normal((6,)).astype(np.float32)
        state = ema_update(state, {"p": jnp.asarray(new)}, **kw)
        with torch.no_grad():
            model.weight.copy_(t(new)[:, None])
        ema.update(model)
        np.testing.assert_allclose(ema_model.weight.detach().numpy()[:, 0],
                                   np.asarray(state.params["p"]), rtol=1e-6,
                                   atol=1e-7)
    assert ema.initted == bool(state.initted) and ema.step == int(state.step)


# ------------------------------------------------------ whole train steps

G_CFG = dict(image_size=32, dim_capacity=4, dim_max=32, dim_latent=16,
             style_network=dict(dim=16, depth=1), self_attn_resolutions=(16,),
             self_attn_dim_head=64, self_attn_heads=2,
             cross_attn_resolutions=(), num_conv_kernels=2,
             num_skip_layers_excite=1, unconditional=True)
D_CFG = dict(image_size=32, dim_capacity=4, dim_max=32, attn_heads=2,
             attn_dim_head=64, num_skip_layers_excite=1, unconditional=True)
# a D of 2 heads of 128: the head dim whose R1 runs K5 and K7a/K7b on their
# wider tensor-core route on the card
D_CFG_D128 = dict(D_CFG, attn_dim_head=128)
DIFF_AUGMENT = dict(prob=1.0, horizontal_flip=True)
LR, BETAS, BATCH = 2e-4, (0.5, 0.9), 2
ADAM_COUNT = 10  # the mid-run optimizer state


def mid_run_nu(grads):
    """Adam's second moment of the mid-run state: per leaf, the square of
    its largest gradient."""
    return jax.tree.map(
        lambda g: np.full(np.shape(g), float(np.abs(g).max()) ** 2 + 1e-30,
                          np.float32), grads)


def jax_adam_update(tx, grads, params):
    state = tx.init(params)
    adam = state[0]._replace(count=jnp.asarray(ADAM_COUNT, jnp.int32),
                             nu=mid_run_nu(grads))
    updates, _ = tx.update(grads, (adam, *state[1:]), params)
    return optax.apply_updates(params, updates)


def seed_adam_state(opt, module, jax_grads):
    nu = convert_params(mid_run_nu(jax_grads), module)
    for name, p in module.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(ADAM_COUNT)),
                        "exp_avg": torch.zeros_like(p),
                        "exp_avg_sq": nu[name].clone()}


def make_jax_setup(d_cfg):
    jg = JaxGenerator(**G_CFG, s2d_trunk=False)
    jdisc = JaxDiscriminator(**d_cfg, s2d_trunk=False)
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
            "latent": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}
    g_params = random_params(jax.eval_shape(
        lambda: jg.init(keys, batch_size=1))["params"], seed=10)
    images = jnp.zeros((1, 32, 32, 3))
    d_params = random_params(jax.eval_shape(lambda: jdisc.init(
        keys, images, jdisc.real_images_to_rgbs(images)))["params"], seed=11)
    tx = jax_get_optimizer(lr=LR, wd=0.0, betas=BETAS)
    builder = JaxTrainStepBuilder(
        jg, jdisc, tx, tx, diff_augment=jlosses.DiffAugment(**DIFF_AUGMENT))
    real = np.random.default_rng(12).random((BATCH, 32, 32, 3)).astype(
        np.float32)
    return builder, tx, g_params, d_params, real


@pytest.fixture(scope="module")
def jax_setup():
    return make_jax_setup(D_CFG)


@pytest.fixture(scope="module")
def jax_setup_d128():
    return make_jax_setup(D_CFG_D128)


def port_gan(g_params, d_params, gp_fwd_over_rev=False, d_cfg=D_CFG):
    gan = GigaGAN(generator=G_CFG, discriminator=d_cfg,
                  diff_augment=DIFF_AUGMENT, learning_rate=LR, betas=BETAS,
                  device="cpu", seed=0, gp_fwd_over_rev=gp_fwd_over_rev)
    gan.load_jax_params(g_params, d_params=d_params)
    return gan


def check_leaves(module, jax_tree, what, check):
    want = convert_params(jax_tree, module)
    got = dict(module.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        check(name, got[name], w.numpy(), what)


def grads_within(name, p, want, what):
    assert p.grad is not None, f"{what}: {name} got no gradient"
    err = np.abs(p.grad.numpy() - want).max()
    assert err <= 1e-3 * np.abs(want).max(), (what, name, err,
                                              np.abs(want).max())


def params_within(name, p, want, what):
    err = np.abs(p.detach().numpy() - want).max()
    assert err <= 0.05 * LR, (what, name, err / LR)


def check_losses(got, want, names):
    for name in names:
        g, w = float(got[name]), float(want[name])
        assert abs(g - w) <= 1e-4 * abs(w), (name, g, w)


# the discriminator pipeline's draws: the real-side DiffAugment pair and
# one (keep mask, patch scores) pair per reconstruction decoder
D_PIPELINE_DRAWS = 4


@pytest.mark.parametrize(
    "apply_gp,fwd_over_rev,dim_head",
    [(False, False, 64), (True, False, 64), (True, True, 64),
     (False, False, 128), (True, False, 128), (True, True, 128)],
    ids=["no_r1", "r1", "r1_fwd_over_rev", "no_r1-d128", "r1-d128",
         "r1_fwd_over_rev-d128"])
def test_d_step_matches_jax(request, apply_gp, fwd_over_rev, dim_head):
    d_cfg = D_CFG if dim_head == 64 else D_CFG_D128
    builder, tx, g_params, d_params, real = request.getfixturevalue(
        "jax_setup" if dim_head == 64 else "jax_setup_d128")

    if fwd_over_rev:
        builder = JaxTrainStepBuilder(
            builder.G, builder.D, tx, tx,
            diff_augment=jlosses.DiffAugment(**DIFF_AUGMENT),
            gp_fwd_over_rev=True)
    fn = jax.jit(jax.value_and_grad(
        lambda d, key: builder._d_micro_loss(
            {"d": d}, g_params, None, {}, real, None, None, None, key,
            apply_gp=apply_gp, calc_ms=True),
        has_aux=True))
    with numpy_draws(20 + apply_gp, replay=D_PIPELINE_DRAWS
                     if fwd_over_rev else None) as record:
        (_, metrics), grads = fn(d_params, jax.random.PRNGKey(4))
    new_params = jax_adam_update(tx, grads, d_params)

    gan = port_gan(g_params, d_params, gp_fwd_over_rev=fwd_over_rev,
                   d_cfg=d_cfg)
    if dim_head == 128:
        # One of this D's leaky-ReLU pre-activations lies at the kink, and
        # JAX's fp32 step crosses it: its R1 gradient reads 8.0e-3 from the
        # port's float64 step on stages.2.from_rgb.bias, as does the port's
        # fp32 step with G under plain_reference() (whose fakes round as
        # XLA's do); with G on its kernels' plain versions the port's fp32
        # step stays on the float64 side (test_d128_r1_step_float64).  G's
        # forward takes the plain_reference() path here, so that the step
        # holds the d = 128 D, through K3-K7b's plain versions, to JAX.
        plain_g_forward(gan)
    seed_adam_state(gan.d_opt, gan.D, grads)
    got = gan.train_discriminator_step(
        real, apply_gradient_penalty=apply_gp, calc_multiscale_loss=True,
        draws=port_draws(record))
    names = ["divergence", "multiscale_divergence", "aux_reconstruction"]
    check_losses(got, metrics, names + (["gradient_penalty"]
                                        if apply_gp else []))
    check_leaves(gan.D, grads, "d grads", grads_within)
    check_leaves(gan.D, new_params, "d params", params_within)


def plain_g_forward(gan):
    """G's forward under plain_reference() from now on."""
    g_forward = gan.G.forward

    def plain_g(*args, **kwargs):
        with plain_reference():
            return g_forward(*args, **kwargs)

    gan.G.forward = plain_g


def to_float64(gan):
    """The pair in float64: its parameters and each module's compute
    dtype."""
    for module in (gan.G, gan.D):
        module.double()
        for m in module.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64


@pytest.mark.parametrize("fwd_over_rev", [False, True],
                         ids=["r1", "r1_fwd_over_rev"])
def test_d128_r1_step_float64(jax_setup_d128, fwd_over_rev, monkeypatch):
    """Why test_d_step_matches_jax's d = 128 cases run G under
    plain_reference().  In float64 the port's d_step+R1 of the d = 128 D
    gives the same gradients with G on its kernels' plain versions and
    under plain_reference() (1e-4 of each leaf's max): the two G paths
    are one algebra.  The fp32 steps part at a kink: where the fp32 step
    (G under plain_reference(), whose fakes round as XLA's do) and the
    float64 one put one of D's leaky-ReLU pre-activations on opposite
    sides of 0, it lies within 1e-4 of 0.  Run with -s, the test prints
    the steps' distances and the pre-activations that cross."""
    builder, tx, g_params, d_params, real = jax_setup_d128
    if fwd_over_rev:
        builder = JaxTrainStepBuilder(
            builder.G, builder.D, tx, tx,
            diff_augment=jlosses.DiffAugment(**DIFF_AUGMENT),
            gp_fwd_over_rev=True)
    with numpy_draws(21, replay=D_PIPELINE_DRAWS
                     if fwd_over_rev else None) as record:
        jax.eval_shape(lambda d, key: builder._d_micro_loss(
            {"d": d}, g_params, None, {}, real, None, None, None, key,
            apply_gp=True, calc_ms=True), d_params, jax.random.PRNGKey(4))

    from gigagan_tpu_torch.models import discriminator as port_d

    leaky_relu = port_d.leaky_relu

    def step(float64, plain_g):
        gan = port_gan(g_params, d_params, gp_fwd_over_rev=fwd_over_rev,
                       d_cfg=D_CFG_D128)
        if plain_g:
            plain_g_forward(gan)
        if float64:
            to_float64(gan)
        pre = []

        def recording(x, *args, **kwargs):
            pre.append(x.detach().double())
            return leaky_relu(x, *args, **kwargs)

        monkeypatch.setattr(port_d, "leaky_relu", recording)
        gan.train_discriminator_step(
            real.astype(np.float64) if float64 else real,
            apply_gradient_penalty=True, calc_multiscale_loss=True,
            draws=port_draws(record))
        monkeypatch.setattr(port_d, "leaky_relu", leaky_relu)
        return {n: p.grad.double() for n, p in gan.D.named_parameters()}, pre

    def distance(got, want):
        return max(((got[n] - w).abs().max() / w.abs().max()).item()
                   for n, w in want.items())

    (g64, pre64), (g64_kernel_g, _) = step(True, True), step(True, False)
    assert distance(g64_kernel_g, g64) <= 1e-4
    for plain_g in (True, False):
        got, pre = step(False, plain_g)
        assert len(pre) == len(pre64)
        crossing = torch.cat([w[torch.sign(x) != torch.sign(w)]
                              for x, w in zip(pre, pre64)])
        path = ("under plain_reference()" if plain_g
                else "on its kernels' plain versions")
        print(f"fp32 step, G {path}: {distance(got, g64):.3e} from the "
              f"float64 step; pre-activations crossing 0 (float64 values): "
              f"{crossing.tolist()}")
        assert (crossing.abs() <= 1e-4).all()
    print(f"float64 steps, G on the two paths: "
          f"{distance(g64_kernel_g, g64):.3e} apart")


def test_g_step_matches_jax(jax_setup):
    builder, tx, g_params, d_params, real = jax_setup
    fn = jax.jit(jax.value_and_grad(
        lambda g, key: builder._g_micro_loss(
            g, d_params, None, None, {}, real, None, None, key,
            calc_ms=True),
        has_aux=True))
    with numpy_draws(30) as record:
        (_, metrics), grads = fn(g_params, jax.random.PRNGKey(5))
    new_params = jax_adam_update(tx, grads, g_params)
    ema = ema_update(EMAState.create(g_params), new_params)

    gan = port_gan(g_params, d_params)
    seed_adam_state(gan.g_opt, gan.G, grads)
    got = gan.train_generator_step(BATCH, calc_multiscale_loss=True,
                                   draws=port_draws(record))
    check_losses(got, metrics, ["divergence", "multiscale_divergence"])
    check_leaves(gan.G, grads, "g grads", grads_within)
    check_leaves(gan.G, new_params, "g params", params_within)
    check_leaves(gan.G_ema, ema.params, "ema params", params_within)
    assert all(p.grad is None for p in gan.D.parameters())


def test_train_loop_runs_r1_every_fourth_step():
    gan = GigaGAN(generator=dict(G_CFG, image_size=16,
                                 self_attn_resolutions=()),
                  discriminator=dict(D_CFG, image_size=16,
                                     attn_resolutions=()),
                  device="cpu", seed=0, log_steps_every=1)
    gan.set_dataloader(MockImageDataset(16, length=8).get_dataloader(BATCH))
    log = gan.train(4)
    assert [r["step"] for r in log] == [1, 2, 3, 4]
    assert [r["d_gradient_penalty"] > 0 for r in log] == [False] * 3 + [True]
    assert all(np.isfinite(v) for r in log for v in r.values())
    assert gan.steps == 5 and gan.ema.step == 4


def small_gan(**kwargs):
    return GigaGAN(generator=dict(G_CFG, image_size=16,
                                  self_attn_resolutions=()),
                   discriminator=dict(D_CFG, image_size=16,
                                      attn_resolutions=()),
                   device="cpu", seed=0, **kwargs)


class CountingLoader:
    """A dataloader that counts the batches drawn from it."""

    def __init__(self, dl):
        self.dl, self.drawn = dl, 0

    def __iter__(self):
        for batch in self.dl:
            self.drawn += 1
            yield batch


def test_train_draws_a_batch_for_each_step():
    # as GigaGAN.forward of the JAX trainer: the d_step and the g_step each
    # collect a batch, so D sees every other batch of the dataloader
    gan = small_gan(log_steps_every=100)
    loader = CountingLoader(
        MockImageDataset(16, length=8).get_dataloader(BATCH))
    gan.set_dataloader(loader)
    gan.train(4)
    assert loader.drawn == 8


def test_generate_samples_the_trained_g_without_an_ema():
    # as JAX's _generate_params: with no EMA generator, use_ema=True samples
    # the trained parameters, not G's initial copy
    gan = small_gan(create_ema_generator_at_init=False, log_steps_every=100)
    gan.set_dataloader(MockImageDataset(16, length=8).get_dataloader(BATCH))
    gan.train(1)
    # the step moved G away from its initial copy
    assert any(not torch.equal(p, q) for p, q in zip(
        gan.G.parameters(), gan.G_ema.parameters()))
    got = gan.generate(batch_size=2, seed=3)
    np.testing.assert_array_equal(got, gan.generate(batch_size=2, seed=3,
                                                    use_ema=False))
    assert not gan.has_ema_generator and small_gan().has_ema_generator


def test_fwd_over_rev_matches_reverse_over_reverse(jax_setup):
    # the port's two R1 forms from one mid-run state: the same penalty and
    # the same update (the tolerances of tests/test_train.py's JAX check)
    _, _, g_params, d_params, real = jax_setup
    draws = StepDraws(fake_flip=True, real_flip=False)
    probe = port_gan(g_params, d_params)
    probe.train_discriminator_step(real, apply_gradient_penalty=True,
                                   calc_multiscale_loss=True, seed=5,
                                   draws=draws)
    nu = {n: torch.full_like(p, float(p.grad.abs().max()) ** 2 + 1e-30)
          for n, p in probe.D.named_parameters()}
    out = {}
    for fwd_over_rev in (True, False):
        gan = port_gan(g_params, d_params, gp_fwd_over_rev=fwd_over_rev)
        for n, p in gan.D.named_parameters():
            gan.d_opt.state[p] = {"step": torch.tensor(float(ADAM_COUNT)),
                                  "exp_avg": torch.zeros_like(p),
                                  "exp_avg_sq": nu[n].clone()}
        m = gan.train_discriminator_step(
            real, apply_gradient_penalty=True, calc_multiscale_loss=True,
            seed=5, draws=draws)
        out[fwd_over_rev] = (float(m["gradient_penalty"]),
                             {n: p.detach().clone()
                              for n, p in gan.D.named_parameters()})
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5)
    for n, p in out[False][1].items():
        np.testing.assert_allclose(out[True][1][n].numpy(), p.numpy(),
                                   rtol=5e-3, atol=3e-6, err_msg=n)


@pytest.mark.parametrize("option", ["conditional", "upsampler"])
def test_unported_training_options_raise(option):
    # both paths are ported and refuse a mismatched D as JAX's trainer
    # asserts: a conditional D beside an unconditional G, and an upsampler
    # trainer whose D asks for a multiscale resolution its G does not give
    # (16 -> 32 gives rgbs of 16 only; D_CFG's resolutions are 16 and 8)
    if option == "conditional":
        with pytest.raises(AssertionError,
                           match="conditioning .* must be the generator's"):
            GigaGAN(generator=G_CFG, discriminator=dict(
                D_CFG, unconditional=False, text_dim=16), device="cpu")
    else:
        upsampler = dict(dim=8, image_size=32, input_image_size=16,
                         dim_mults=(1, 2), full_attn=(False, True),
                         style_network=dict(dim=16, depth=1))
        with pytest.raises(AssertionError,
                           match="only multiscale input resolutions of"):
            GigaGAN(generator=upsampler, discriminator=D_CFG,
                    train_upsampler=True, device="cpu")


# ------------------------------------------- accumulation, chunked R1, remat

def capture_tx():
    """An optax transformation whose state is the last gradient it saw."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


ACCUM = 2
ACCUM_REAL = np.random.default_rng(13).random(
    (ACCUM * BATCH, 32, 32, 3)).astype(np.float32)


def jax_accum_step(builder, kind, g_params, d_params, seed, **flags):
    """JAX's jitted accumulating step (``d_step_fn``/``g_step_fn`` with
    ``grad_accum_every=ACCUM``) with a capturing optimizer: (metrics, the
    averaged gradients, the draws of one microbatch).  The scan traces its
    body once, so every microbatch gets the same numpy draws."""
    from gigagan_tpu.train.steps import GANState

    tx = capture_tx()
    state = GANState(g_params=g_params, d_params=d_params,
                     g_opt=tx.init(g_params), d_opt=tx.init(d_params),
                     ema=None, steps=jnp.asarray(1, jnp.int32))
    builder.g_tx = builder.d_tx = tx
    batch = {"real_images": jnp.asarray(ACCUM_REAL.reshape(
        ACCUM, BATCH, 32, 32, 3))}
    if kind == "d":
        fn = builder.d_step_fn(grad_accum_every=ACCUM, calc_ms=True, **flags)
    else:
        fn = builder.g_step_fn(grad_accum_every=ACCUM, calc_ms=True)
    replay = D_PIPELINE_DRAWS if builder.gp_fwd_over_rev else None
    with numpy_draws(seed, replay=replay) as record:
        new_state, metrics = fn(state, batch, jax.random.PRNGKey(seed), {})
    grads = new_state.d_opt if kind == "d" else new_state.g_opt
    return metrics, grads, record


@pytest.mark.parametrize("apply_gp,fwd_over_rev",
                         [(False, False), (True, False), (True, True)],
                         ids=["no_r1", "r1", "r1_fwd_over_rev"])
def test_d_step_with_accumulation_matches_jax(jax_setup, apply_gp,
                                              fwd_over_rev):
    _, tx, g_params, d_params, _ = jax_setup
    builder = JaxTrainStepBuilder(
        JaxGenerator(**G_CFG, s2d_trunk=False),
        JaxDiscriminator(**D_CFG, s2d_trunk=False), tx, tx,
        diff_augment=jlosses.DiffAugment(**DIFF_AUGMENT),
        gp_fwd_over_rev=fwd_over_rev)
    metrics, grads, record = jax_accum_step(
        builder, "d", g_params, d_params, 40 + apply_gp + fwd_over_rev,
        apply_gp=apply_gp)
    new_params = jax_adam_update(tx, grads, d_params)

    gan = port_gan(g_params, d_params, gp_fwd_over_rev=fwd_over_rev)
    seed_adam_state(gan.d_opt, gan.D, grads)
    draws = port_draws(record)
    got = gan.train_discriminator_step(
        ACCUM_REAL, grad_accum_every=ACCUM, apply_gradient_penalty=apply_gp,
        calc_multiscale_loss=True, draws=[draws] * ACCUM)
    names = ["divergence", "multiscale_divergence", "aux_reconstruction"]
    check_losses(got, metrics, names + (["gradient_penalty"]
                                        if apply_gp else []))
    check_leaves(gan.D, grads, "d grads", grads_within)
    check_leaves(gan.D, new_params, "d params", params_within)


def test_g_step_with_accumulation_matches_jax(jax_setup):
    # the draws of test_g_step_matches_jax (numpy seed 30).  The g_step's
    # noise-weight and modulation gradients are sums over pixels that
    # cancel: with some draws (seed 50) a 1e-6 relative change of the
    # parameters moves them by 1.5e-4 of their largest element, and the
    # port and JAX then differ by up to 4.2e-3 in one microbatch alone, with
    # or without accumulation (which changes neither side by more than
    # 5e-6); the accumulation itself is what this test holds
    builder, tx, g_params, d_params, _ = jax_setup
    builder = JaxTrainStepBuilder(
        builder.G, builder.D, tx, tx,
        diff_augment=jlosses.DiffAugment(**DIFF_AUGMENT))
    metrics, grads, record = jax_accum_step(builder, "g", g_params,
                                            d_params, 30)
    new_params = jax_adam_update(tx, grads, g_params)

    gan = port_gan(g_params, d_params)
    seed_adam_state(gan.g_opt, gan.G, grads)
    got = gan.train_generator_step(BATCH, grad_accum_every=ACCUM,
                                   calc_multiscale_loss=True,
                                   draws=[port_draws(record)] * ACCUM)
    check_losses(got, metrics, ["divergence", "multiscale_divergence"])
    check_leaves(gan.G, grads, "g grads", grads_within)
    check_leaves(gan.G, new_params, "g params", params_within)


def test_chunked_r1_matches_jax(jax_setup):
    # JAX's gp_chunk scan at one sample a chunk (two chunks)
    builder, tx, g_params, d_params, real = jax_setup
    builder = JaxTrainStepBuilder(
        builder.G, builder.D, tx, tx,
        diff_augment=jlosses.DiffAugment(**DIFF_AUGMENT), gp_chunk=1)
    fn = jax.jit(jax.value_and_grad(
        lambda d, key: builder._d_micro_loss(
            {"d": d}, g_params, None, {}, real, None, None, None, key,
            apply_gp=True, calc_ms=True),
        has_aux=True))
    with numpy_draws(60) as record:
        (_, metrics), grads = fn(d_params, jax.random.PRNGKey(6))
    new_params = jax_adam_update(tx, grads, d_params)

    gan = GigaGAN(generator=G_CFG, discriminator=D_CFG,
                  diff_augment=DIFF_AUGMENT, learning_rate=LR, betas=BETAS,
                  device="cpu", seed=0, gp_chunk=1)
    gan.load_jax_params(g_params, d_params=d_params)
    seed_adam_state(gan.d_opt, gan.D, grads)
    got = gan.train_discriminator_step(
        real, apply_gradient_penalty=True, calc_multiscale_loss=True,
        draws=port_draws(record))
    check_losses(got, metrics, ["divergence", "multiscale_divergence",
                                "aux_reconstruction", "gradient_penalty"])
    check_leaves(gan.D, grads, "d grads", grads_within)
    check_leaves(gan.D, new_params, "d params", params_within)


def d_grads(gan, real, **kwargs):
    m = gan.train_discriminator_step(real, apply_gradient_penalty=True,
                                     calc_multiscale_loss=True, **kwargs)
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.detach().clone() for n, p in gan.D.named_parameters()})


def test_chunked_r1_matches_the_unchunked_one(jax_setup):
    # the chunked penalty runs on the un-augmented pipeline, so it equals
    # the unchunked penalty of a step whose flips are both off
    _, _, g_params, d_params, _ = jax_setup
    draws = StepDraws(fake_flip=False, real_flip=False)
    out = {}
    for chunk in (None, 1, 2):
        gan = GigaGAN(generator=G_CFG, discriminator=D_CFG,
                      diff_augment=DIFF_AUGMENT, device="cpu", seed=0,
                      gp_chunk=chunk)
        gan.load_jax_params(g_params, d_params=d_params)
        out[chunk] = d_grads(gan, ACCUM_REAL, seed=8, draws=draws)
    (want_m, want_g) = out[None]
    for chunk in (1, 2):
        got_m, got_g = out[chunk]
        for k, w in want_m.items():
            assert abs(got_m[k] - w) <= 1e-5 * abs(w), (chunk, k, got_m[k], w)
        for n, g in got_g.items():
            err = float((g - want_g[n]).abs().max())
            assert err <= 1e-3 * float(want_g[n].abs().max()), (chunk, n, err)
    gan = GigaGAN(generator=G_CFG, discriminator=D_CFG, device="cpu",
                  gp_chunk=3)
    with pytest.raises(AssertionError, match="must divide"):
        d_grads(gan, ACCUM_REAL, seed=8)


@pytest.mark.parametrize("case", ["d_r1", "d_r1_fwd_over_rev",
                                  "d_r1_remat_stages", "g"])
def test_remat_matches_no_remat(jax_setup, case):
    # the same seed and no explicit draws: the recomputation must replay the
    # generators' draws (latents, pixel noise, flips, the decoder's mask)
    _, _, g_params, d_params, _ = jax_setup
    out = []
    for remat in (False, True):
        kwargs = dict(gp_fwd_over_rev=case == "d_r1_fwd_over_rev")
        d_cfg = D_CFG
        if case == "d_r1_remat_stages":
            d_cfg = dict(D_CFG, remat_stages=remat)
        else:
            kwargs["remat"] = remat
        gan = GigaGAN(generator=G_CFG, discriminator=d_cfg,
                      diff_augment=DIFF_AUGMENT, device="cpu", seed=0,
                      **kwargs)
        gan.load_jax_params(g_params, d_params=d_params)
        if case == "g":
            m = gan.train_generator_step(BATCH, calc_multiscale_loss=True,
                                         seed=9)
            out.append(({k: float(v) for k, v in m.items()},
                        {n: p.grad.detach().clone()
                         for n, p in gan.G.named_parameters()}))
        else:
            out.append(d_grads(gan, ACCUM_REAL[:BATCH], seed=9))
    (want_m, want_g), (got_m, got_g) = out
    for k, w in want_m.items():
        assert abs(got_m[k] - w) <= 1e-5 * abs(w), (k, got_m[k], w)
    for n, g in got_g.items():
        err = float((g - want_g[n]).abs().max())
        assert err <= 1e-5 * float(want_g[n].abs().max()), (n, err)
