"""The weight bridge (JAX generator params → the port's state_dict), the
port's GigaGAN sampling API on the CPU, and package hygiene: the port
imports no JAX and needs neither nvcc nor a GPU to import."""

import ast
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu.models.generator import Generator as JaxGenerator  # noqa: E402

from gigagan_tpu_torch import GigaGAN, Generator  # noqa: E402
from gigagan_tpu_torch.convert import convert_params  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "gigagan_tpu_torch"

G_CONFIG = dict(
    image_size=16, dim_capacity=4, dim_max=32, dim_latent=16,
    style_network=dict(dim=8, depth=2), self_attn_resolutions=(8,),
    self_attn_dim_head=4, self_attn_heads=2, cross_attn_resolutions=(),
    num_conv_kernels=2, num_skip_layers_excite=1, unconditional=True,
)


@pytest.fixture(scope="module")
def jax_params():
    jg = JaxGenerator(**G_CONFIG, s2d_trunk=False)
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
            "latent": jax.random.PRNGKey(2)}
    params = jax.device_get(jg.init(keys, batch_size=1)["params"])
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params
    )


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ------------------------------------------------------------------ bridge

def test_every_leaf_consumed_and_every_parameter_filled(jax_params):
    g = Generator(**G_CONFIG)
    state = convert_params(jax_params, g)
    assert set(state) == set(g.state_dict())
    n_leaves = sum(1 for _ in flat(jax_params))
    assert len(state) == n_leaves
    assert sum(v.numel() for v in state.values()) == sum(
        v.size for _, v in flat(jax_params))
    g.load_state_dict(state)  # strict


def test_layouts(jax_params):
    state = convert_params(jax_params, Generator(**G_CONFIG))
    np.testing.assert_array_equal(state["init_block"],
                                  jax_params["init_block"])
    np.testing.assert_array_equal(state["stages.1.conv1.weights"],
                                  jax_params["stages_1_conv1"]["weights"])
    np.testing.assert_array_equal(
        state["style_to_conv_modulations.weight"],
        jax_params["style_to_conv_modulations"]["kernel"].T)
    np.testing.assert_array_equal(state["style_net.linear_1.weight"],
                                  jax_params["style_net"]["linear_1"]
                                  ["weight"].T)
    np.testing.assert_array_equal(
        state["stages.1.self_attn.attn.null_kv"],
        jax_params["stages_1_self_attn"]["attn"]["null_kv"])


@pytest.mark.parametrize("fault", ["extra_leaf", "missing_leaf", "bad_shape"])
def test_bridge_fails_loudly(jax_params, fault):
    params = jax.tree.map(np.array, jax_params)
    if fault == "extra_leaf":
        params["stages_0_conv1"]["stray"] = np.zeros(3, np.float32)
        match = "unconsumed JAX leaves.*stages.0.conv1.stray"
    elif fault == "missing_leaf":
        del params["stages_0_noise2"]
        match = "unfilled parameters.*stages.0.noise2.weight"
    else:
        params["stages_0_noise1"]["weight"] = np.zeros(5, np.float32)
        match = "stages.0.noise1.weight: JAX shape"
    with pytest.raises(ValueError, match=match):
        convert_params(params, Generator(**G_CONFIG))


# ---------------------------------------------------------------- sampling

def test_generate_is_deterministic_on_cpu(jax_params):
    gan = GigaGAN(generator=G_CONFIG, device="cpu", seed=0)
    gan.load_jax_params(jax_params)
    a = gan.generate(batch_size=3, seed=11)
    b = gan.generate(batch_size=3, seed=11)
    c = gan.generate(batch_size=3, seed=12)
    assert a.shape == (3, 16, 16, 3) and a.dtype == np.float32
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    np.testing.assert_array_equal(a, gan.generate(batch_size=3, seed=11,
                                                  use_ema=False))


def test_generate_seeds_and_ema(jax_params):
    gan = GigaGAN(generator=G_CONFIG, device="cpu", seed=0)
    ema = jax.tree.map(lambda a: a * 0.5, jax_params)
    gan.load_jax_params(jax_params, ema_params=ema)
    raw = gan.generate(batch_size=2, seed=5, use_ema=False)
    assert not np.allclose(raw, gan.generate(batch_size=2, seed=5))
    # same construction seed → same random init, independent of the device
    # placement of the sampling generators
    g1 = GigaGAN(generator=G_CONFIG, device="cpu", seed=3)
    g2 = GigaGAN(generator=G_CONFIG, device="cpu", seed=3)
    np.testing.assert_array_equal(g1.generate(batch_size=1, seed=0),
                                  g2.generate(batch_size=1, seed=0))
    styles = np.zeros((2, 8), np.float32)
    out = g1.generate(styles=styles, seed=0)
    assert out.shape == (2, 16, 16, 3)


@pytest.mark.parametrize("kwargs,match", [
    (dict(unconditional=False), "dim_text_latent"),
])
def test_unported_generator_options_raise(kwargs, match):
    # the conditional generator is ported; one without a text encoder fails
    # as JAX's setup assertion does
    config = {**G_CONFIG, **kwargs}
    with pytest.raises(AssertionError, match=match):
        Generator(**config)
    with pytest.raises(AssertionError, match=match):
        JaxGenerator(**config, s2d_trunk=False).init(
            {"params": jax.random.PRNGKey(0),
             "latent": jax.random.PRNGKey(1)}, batch_size=1)


def test_gigagan_runs_on_the_card_unless_asked(monkeypatch):
    # no device means the card; without one it raises and names the CPU
    # option instead of quietly running there
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GigaGAN(generator=G_CONFIG)
    assert GigaGAN(generator=G_CONFIG, device="cpu").device.type == "cpu"


def test_discriminator_raises_until_ported():
    # a conditional discriminator (the default) needs a text encoder or a
    # text dim, and its conditioning must be the generator's, as JAX asserts
    with pytest.raises(AssertionError,
                       match="exactly one of text_dim and text_encoder"):
        GigaGAN(generator=G_CONFIG, discriminator=dict(image_size=16),
                device="cpu")
    with pytest.raises(AssertionError,
                       match="conditioning .* must be the generator's"):
        GigaGAN(generator=G_CONFIG, discriminator=dict(image_size=16,
                                                       text_dim=8),
                device="cpu")


# ----------------------------------------------------------------- hygiene

def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def port_sources():
    sources = [p for p in PORT.rglob("*.py") if "_build" not in p.parts]
    return sorted(sources) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "flax", "optax", "gigagan_tpu",
                                  "orbax", "tensorstore", "zstandard",
                                  "xxhash")]
    assert not bad, f"{path}: imports {bad}"
    # no library attention in the package or in chip_smoke.py, which holds
    # the kernels to their plain versions only; chip_smoke.py may name
    # torch.backends.cudnn, to turn TF32 off
    text = path.read_text()
    words = ["torch.compile", "scaled_dot_product_attention", "sdpa_kernel",
             "sdp_kernel", "cudnn_attention"]
    if PORT in path.parents:
        words.append("torch.backends.cudnn")
    for word in words:
        assert word not in text, f"{path} uses {word}"


def test_importing_the_port_needs_no_jax_nvcc_or_gpu(tmp_path):
    code = (
        "import sys\n"
        "import gigagan_tpu_torch\n"
        "from gigagan_tpu_torch.ops.kernels import build\n"
        "import gigagan_tpu_torch.ops.kernels.adaptive_conv\n"
        "import gigagan_tpu_torch.ops.kernels.flash_attention_fused\n"
        "import gigagan_tpu_torch.ops.kernels.flash_attention_hv\n"
        "import gigagan_tpu_torch.health_run\n"
        "import gigagan_tpu_torch.cli\n"
        "import gigagan_tpu_torch.eval\n"
        "import gigagan_tpu_torch.parallel\n"
        "import gigagan_tpu_torch.train.jax_checkpoint\n"
        "import gigagan_tpu_torch.train.orbax_checkpoint\n"
        "import gigagan_tpu_torch.utils.png\n"
        "assert not build._LIBS\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'gigagan_tpu', 'triton', 'PIL', 'msgpack', "
        "'orbax', 'tensorstore', 'zstandard', 'xxhash')]\n"
        "assert not bad, bad\n"
        "try:\n"
        "    build.nvcc_path()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc not found' in str(e)\n"
        "else:\n"
        "    raise AssertionError('nvcc found')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "no-cuda"), CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
