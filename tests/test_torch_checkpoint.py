"""The port's reader of the JAX package's checkpoints
(``gigagan_tpu_torch/train/jax_checkpoint.py``) against flax's own
serialization and the JAX trainer.

- ``msgpack_restore`` against ``flax.serialization.msgpack_serialize`` on
  trees of every dtype a train state holds, and on chunked leaves
  (flax's ``MAX_CHUNK_SIZE`` made small);
- a tiny JAX ``GigaGAN`` state (its optimizers and EMA one update in)
  written by the JAX trainer's ``save`` and read by the port with
  ``msgpack`` blocked from import: G, G_ema and D give the JAX outputs on
  the same inputs and noise (1e-4 relative), and one more Adam(W) step
  from the mapped moments, optax or flat layout, gives JAX's next step
  (1e-4 relative);
- a misfit optimizer state is reset, ``strict=True`` raises, and ``load``
  tells the two formats apart.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from flax import linen as nn  # noqa: E402
from flax import serialization  # noqa: E402

from gigagan_tpu.models import layers as jl  # noqa: E402
from gigagan_tpu.train import GigaGAN as JaxGigaGAN  # noqa: E402
from gigagan_tpu.train.optimizer import get_optimizer as jax_optimizer  # noqa
from gigagan_tpu.train.ema import ema_update  # noqa: E402

from gigagan_tpu_torch import GigaGAN  # noqa: E402
from gigagan_tpu_torch.convert import convert_params  # noqa: E402
from gigagan_tpu_torch.models import layers as tl  # noqa: E402
from gigagan_tpu_torch.train import jax_checkpoint  # noqa: E402

G_CONFIG = dict(image_size=16, dim_capacity=4, dim_max=32, dim_latent=32,
                style_network=dict(dim=16, depth=1),
                self_attn_resolutions=(8,), self_attn_dim_head=8,
                self_attn_heads=2, cross_attn_resolutions=(),
                num_skip_layers_excite=2, unconditional=True)
D_CONFIG = dict(image_size=16, dim_capacity=4, dim_max=32,
                attn_resolutions=(8,), multiscale_input_resolutions=(8,),
                aux_recon_resolutions=(8,), unconditional=True)
OUT_TOL = 1e-4   # G, G_ema and D outputs, relative to max |JAX|
STEP_TOL = 1e-4  # the next Adam(W) step's parameters, relative
# the trainers' betas; a learning rate large enough that one step stands
# far above fp32's rounding of the parameters it moves
LR, BETAS = 0.05, (0.5, 0.9)


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


# ------------------------------------------------------------------ reader


def as_numpy(x):
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    return x


def assert_same_tree(ours, flax_tree, path="root"):
    if isinstance(flax_tree, dict):
        assert isinstance(ours, dict) and list(ours) == list(flax_tree), path
        for k in flax_tree:
            assert_same_tree(ours[k], flax_tree[k], f"{path}/{k}")
    elif isinstance(flax_tree, (list, tuple)):
        assert isinstance(ours, list) and len(ours) == len(flax_tree), path
        for i, (a, b) in enumerate(zip(ours, flax_tree)):
            assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(flax_tree, (np.ndarray, np.generic)):
        assert torch.is_tensor(ours), path
        want = np.asarray(flax_tree)
        assert tuple(ours.shape) == want.shape, path
        if want.dtype.name == "bfloat16":
            assert ours.dtype == torch.bfloat16, path
            want = want.astype(np.float32)
        else:
            assert ours.numpy().dtype == want.dtype, path
        np.testing.assert_array_equal(as_numpy(ours), want, err_msg=path)
    else:
        assert type(ours) is type(flax_tree) and ours == flax_tree, path


def dtype_tree():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "bf16": jnp.asarray(rng.standard_normal((5, 2)), jnp.bfloat16),
        "i32": np.arange(-3, 4, dtype=np.int32).reshape(7, 1),
        "u32_key": np.asarray(jax.random.PRNGKey(7)),
        "bool": np.array([True, False, True]),
        "bool0": np.asarray(False),
        "i32_0": jnp.asarray(1, jnp.int32),
        "scalars": {"f32": np.float32(1.5), "i32": np.int32(-9),
                    "bf16": jnp.bfloat16(0.375)},
        "nested": {"a": {"b": {"c": rng.random(6).astype(np.float32)}},
                   "empty": {}},
        "empty": {},
        "none": None,
        "python": {"int": 300, "neg": -70000, "big": 2 ** 40,
                   "float": 0.1, "str": "0.1.0", "true": True},
        "f64": rng.standard_normal(4),
        "zero_size": np.zeros((0, 3), np.float32),
    }


@pytest.mark.parametrize("key", list(dtype_tree()))
def test_reader_matches_flax_restore(key):
    tree = {key: dtype_tree()[key], "after": np.float32(2.0)}
    data = serialization.msgpack_serialize(tree)
    assert_same_tree(jax_checkpoint.msgpack_restore(data),
                     serialization.msgpack_restore(data))


def test_reader_reads_chunked_leaves(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"big": rng.standard_normal((7, 9)).astype(np.float32),
            "bf16": jnp.asarray(rng.standard_normal(70), jnp.bfloat16),
            "small": np.arange(3, dtype=np.int32),
            "nested": {"big": rng.standard_normal((40,))}}
    data = serialization.msgpack_serialize(tree)
    assert jax_checkpoint.CHUNKED.encode() in data
    ours = jax_checkpoint.msgpack_restore(data)
    assert_same_tree(ours, serialization.msgpack_restore(data))
    assert tuple(ours["big"].shape) == (7, 9)


def test_reader_refuses_complex_and_trailing_bytes():
    with pytest.raises(ValueError, match="complex"):
        jax_checkpoint.msgpack_restore(
            serialization.msgpack_serialize({"c": complex(1, 2)}))
    data = serialization.msgpack_serialize({"a": 1})
    with pytest.raises(ValueError, match="after"):
        jax_checkpoint.msgpack_restore(data + b"\x00")


# ---------------------------------------------------------- the JAX state


@pytest.fixture(scope="module")
def jax_gan(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_gan")
    gan = JaxGigaGAN(generator=G_CONFIG, discriminator=D_CONFIG, seed=0,
                     model_folder=str(root / "models"),
                     results_folder=str(root / "results"))
    gan.initial_state = gan.state
    return gan


def random_like(tree, rng, scale=1.0):
    return jax.tree.map(
        lambda x: jnp.asarray(scale * rng.standard_normal(np.shape(x)),
                              jnp.float32), tree)


def jax_state(gan, layout, wd, seed=0):
    """The JAX trainer's state one update in: both optimizers (of
    ``layout``, with weight decay ``wd``) stepped on random gradients, the
    EMA updated (past its warm-up, so that it differs from G), the step
    counter moved; and the optimizers with the second gradients."""
    rng = np.random.default_rng(seed)
    state = gan.initial_state
    out, txs, second = {}, {}, {}
    for key in ("g", "d"):
        tx = jax_optimizer(lr=LR, wd=wd, betas=BETAS, flat=layout == "flat")
        params = getattr(state, f"{key}_params")
        opt = tx.init(params)
        updates, opt = tx.update(random_like(params, rng), opt, params)
        out[f"{key}_params"] = optax.apply_updates(params, updates)
        out[f"{key}_opt"] = opt
        txs[key] = tx
        second[key] = random_like(params, rng)
    ema = state.ema.replace(step=jnp.asarray(110, jnp.int32))
    ema = ema_update(ema, jax.tree.map(lambda x: x * 1.01,
                                       out["g_params"]),
                     update_every=1)
    out["ema"] = ema
    out["steps"] = jnp.asarray(7, jnp.int32)
    return state.replace(**out), txs, second


def jax_next_params(state, txs, second, key):
    params = getattr(state, f"{key}_params")
    updates, _ = txs[key].update(second[key], getattr(state, f"{key}_opt"),
                                 params)
    return optax.apply_updates(params, updates)


def saved_checkpoint(gan, state, path):
    gan.state = state
    gan.save(path)
    return path


def port_gan(wd=0.0, **kwargs):
    return GigaGAN(generator=G_CONFIG, discriminator=D_CONFIG,
                   learning_rate=LR, weight_decay=wd, seed=1, device="cpu",
                   **kwargs)


def jax_generator_out(gan, params, latents, noises):
    it = iter(noises)

    def interceptor(next_fun, args, kwargs, context):
        if (isinstance(context.module, jl.Noise)
                and context.method_name == "__call__"):
            kwargs = dict(kwargs, noise=jnp.asarray(next(it)))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(interceptor):
        return np.asarray(gan.G.apply({"params": params},
                                      noise=jnp.asarray(latents)))


def noise_for(module, latents, seed):
    """Numpy pixel noise for each Noise layer of ``module``, at the shapes
    one forward gives them (recorded by a first pass)."""
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append(args[0].shape))
        for m in module.modules() if isinstance(m, tl.Noise)]
    with torch.no_grad():
        module(noise=t(latents))
    for h in hooks:
        h.remove()
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((*s[:-1], 1)).astype(np.float32)
            for s in shapes]


def port_generator_out(module, latents, noises):
    it = iter(noises)

    def hook(mod, args, kwargs):
        return args, dict(kwargs, noise=t(next(it)))

    hooks = [m.register_forward_pre_hook(hook, with_kwargs=True)
             for m in module.modules() if isinstance(m, tl.Noise)]
    with torch.no_grad():
        out = module(noise=t(latents))
    for h in hooks:
        h.remove()
    return out.numpy()


@pytest.fixture
def no_msgpack(monkeypatch):
    """``import msgpack`` (and flax's serialization) fail while the port
    reads."""
    monkeypatch.setitem(sys.modules, "msgpack", None)


def test_jax_checkpoint_gives_the_jax_outputs(jax_gan, tmp_path,
                                              monkeypatch):
    state, _, _ = jax_state(jax_gan, "optax", 0.0)
    path = saved_checkpoint(jax_gan, state, tmp_path / "model-3.ckpt")
    gan = port_gan()
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "msgpack", None)
        gan.load(path, strict=True)
    assert gan.steps == 7
    assert gan.ema.step == 111 and gan.ema.initted

    rng = np.random.default_rng(3)
    latents = rng.standard_normal((2, 16)).astype(np.float32)
    noises = noise_for(gan.G, latents, seed=4)
    for module, params in ((gan.G, state.g_params),
                           (gan.G_ema, state.ema.params)):
        want = jax_generator_out(jax_gan, params, latents, noises)
        got = port_generator_out(module, latents, noises)
        assert got.shape == want.shape
        assert rel_err(got, want) <= OUT_TOL
    # the EMA's params are its own, not G's
    assert rel_err(port_generator_out(gan.G_ema, latents, noises),
                   port_generator_out(gan.G, latents, noises)) > 1e-3

    images = rng.random((2, 16, 16, 3)).astype(np.float32)
    rgbs = [np.asarray(r) for r in
            jax_gan.D.real_images_to_rgbs(jnp.asarray(images))]
    logits_j, ms_j, _ = jax_gan.D.apply(
        {"params": state.d_params}, jnp.asarray(images),
        [jnp.asarray(r) for r in rgbs], calc_aux_loss=False)
    with torch.no_grad():
        logits, ms, _ = gan.D(t(images), [t(r) for r in rgbs],
                              calc_aux_loss=False)
    assert rel_err(logits.numpy(), logits_j) <= OUT_TOL
    for a, b in zip(ms, ms_j, strict=True):
        assert rel_err(a.numpy(), b) <= OUT_TOL


@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["adam", "adamw"])
@pytest.mark.parametrize("layout", ["optax", "flat"])
def test_adam_moments_give_the_next_jax_step(jax_gan, tmp_path, no_msgpack,
                                             layout, wd, capsys):
    state, txs, second = jax_state(jax_gan, layout, wd, seed=5)
    path = saved_checkpoint(jax_gan, state, tmp_path / "model-1.ckpt")
    gan = port_gan(wd=wd)
    gan.load_jax_checkpoint(path, strict=True)
    assert "reset" not in capsys.readouterr().out
    for key, module, opt in (("g", gan.G, gan.g_opt),
                             ("d", gan.D, gan.d_opt)):
        grads = convert_params(second[key], module)
        named = dict(module.named_parameters())
        for name, p in named.items():
            p.grad = grads[name].clone()
        opt.step()
        want = convert_params(jax_next_params(state, txs, second, key),
                              module)
        for name, p in named.items():
            before = convert_params(getattr(state, f"{key}_params"),
                                    module)[name]
            step = (p.detach() - before).numpy()
            assert rel_err(step, (want[name] - before).numpy()) <= \
                STEP_TOL, f"{key} {name}"
            assert rel_err(p.detach().numpy(), want[name].numpy()) <= \
                STEP_TOL, f"{key} {name}"


def test_misfit_optimizer_state_is_reset(jax_gan, tmp_path, no_msgpack,
                                         capsys):
    state, _, _ = jax_state(jax_gan, "optax", 0.0)
    # the G moments of another model: one leaf's shape differs
    mu = state.g_opt[0].mu
    bad = dict(mu, init_block=jnp.zeros((2, 2, 7), jnp.float32))
    state = state.replace(g_opt=(state.g_opt[0]._replace(mu=bad),
                                 *state.g_opt[1:]))
    path = saved_checkpoint(jax_gan, state, tmp_path / "model-2.ckpt")
    gan = port_gan()
    with pytest.raises(RuntimeError, match="g_opt does not fit"):
        gan.load(path, strict=True)
    gan.load(path)
    out = capsys.readouterr().out
    assert "unable to load g_opt state; g_opt will be reset" in out
    assert "unable to load d_opt" not in out
    assert not gan.g_opt.state and gan.d_opt.state
    # the parameters loaded all the same
    want = convert_params(state.g_params, gan.G)
    for name, p in gan.G.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      want[name].numpy())


def test_load_tells_the_formats_apart(jax_gan, tmp_path, no_msgpack):
    state, _, _ = jax_state(jax_gan, "optax", 0.0)
    jax_path = saved_checkpoint(jax_gan, state, tmp_path / "jax.ckpt")
    gan = port_gan()
    torch_path = tmp_path / "port.ckpt"
    gan.save(torch_path)
    assert jax_checkpoint.checkpoint_format(jax_path) == "jax"
    assert jax_checkpoint.checkpoint_format(torch_path) == "torch"
    other = port_gan()
    other.load(jax_path, strict=True)
    other.load(torch_path, strict=True)
    for a, b in zip(other.G.parameters(), gan.G.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not a JAX"):
        other.load_jax_checkpoint(torch_path)
    orbax = tmp_path / "orbax-ckpt"
    orbax.mkdir()  # a directory is read as orbax: this one holds nothing
    with pytest.raises(ValueError, match="no _METADATA"):
        other.load(orbax)
    junk = tmp_path / "junk.ckpt"
    junk.write_bytes(b"\x00\x01\x02\x03")
    with pytest.raises(ValueError, match="neither"):
        other.load(junk)
