"""The port's command line (``python -m gigagan_tpu_torch``,
``gigagan_tpu_torch/cli.py``): the cases of ``tests/test_cli.py`` at a
tiny width with ``--device cpu``, a model folder written by the JAX
package's CLI (``tests/torch_fixtures``, remade by its
``make_jax_model_folder.py``) sampled by the port with the JAX generator's
outputs (1e-4 relative), the JAX-only config keys, and the standard-library
PNG reader (``gigagan_tpu_torch/utils/png.py``)."""

import json
import shutil
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu_torch import cli  # noqa: E402
from gigagan_tpu_torch.models import layers as tl  # noqa: E402
from gigagan_tpu_torch.utils import png  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
JAX_OUT_TOL = 1e-4  # the JAX-written folder's G outputs, relative

TINY = {
    "generator": {
        "dim_capacity": 4,
        "style_network": {"dim": 16, "depth": 1},
        "image_size": 16,
        "dim_max": 32,
        "self_attn_resolutions": (),
        "cross_attn_resolutions": (),
        "unconditional": True,
    },
    "discriminator": {
        "dim_capacity": 4,
        "dim_max": 32,
        "image_size": 16,
        "attn_resolutions": (),
        "multiscale_input_resolutions": (8,),
        "aux_recon_resolutions": (8,),
        "unconditional": True,
    },
    "amp": False,
    "apply_gradient_penalty_every": 0,
    "log_steps_every": 10 ** 9,
    "save_and_sample_every": 2,
    "early_save_thres_steps": 0,
    "num_samples": 4,
    "seed": 0,
}
TINY_UP = {
    "train_upsampler": True,
    "generator": {
        "style_network": {"dim": 16, "depth": 1},
        "dim": 8,
        "image_size": 16,
        "input_image_size": 8,
        "dim_mults": (1, 2),
        "full_attn": (False, True),
        "cross_attn": (False, False),
        "attn_depths": (1, 1),
        "temporal_attn_depths": (1, 1),
        "num_conv_kernels": 2,
        "unconditional": True,
    },
    "discriminator": {
        "dim_capacity": 4,
        "dim_max": 32,
        "image_size": 16,
        "attn_resolutions": (),
        "multiscale_input_resolutions": (8,),
        "aux_recon_resolutions": (),
        "aux_recon_patch_dims": (),
        "aux_recon_frac_patches": (),
        "unconditional": True,
    },
    "amp": False,
    "apply_gradient_penalty_every": 0,
    "log_steps_every": 10 ** 9,
    "save_and_sample_every": 1,
    "early_save_thres_steps": 0,
    "num_samples": 2,
    "seed": 0,
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def trained_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cfg_path = root / "cfg.json"
    cfg_path.write_text(json.dumps(TINY, default=list))
    models, results = root / "models", root / "results"
    rc = cli.main(["train", "--config", str(cfg_path), "--mock-data",
                   "--image-size", "16", "--batch-size", "8", "--steps",
                   "2", "--models", str(models), "--results", str(results),
                   "--device", "cpu"])
    assert rc == 0
    return models, results


def test_train_writes_config_and_checkpoint(trained_folder):
    models, results = trained_folder
    cfg = json.loads((models / "config.json").read_text())
    assert cfg["generator"]["image_size"] == 16
    assert cfg["model_folder"] == str(models)
    # steps 1 and 2 both end at milestone 3 // 2 = 1
    assert [p.name for p in cli._checkpoints(models)] == ["model-1.ckpt"]
    assert list(results.glob("sample-*.png"))
    assert list(results.glob("ema-sample-*.png"))


def test_generate_from_model_folder(trained_folder, tmp_path):
    models, _ = trained_folder
    out = tmp_path / "grid.png"
    rc = cli.main(["generate", "--models", str(models), "--num", "4",
                   "--seed", "0", "--out", str(out), "--device", "cpu"])
    assert rc == 0
    img = png.decode_png(out.read_bytes())
    assert img.shape == (2 * 16 + 3 * 2, 2 * 16 + 3 * 2, 3)
    assert img.std() > 0  # not a constant image


def test_evaluate_from_model_folder(trained_folder, tmp_path):
    """CLIP-FID of the EMA samples against the mock reals, on random-init
    CLIP (no asset here), and the record says so."""
    models, _ = trained_folder
    out = tmp_path / "eval.json"
    rc = cli.main(["evaluate", "--models", str(models), "--mock-data",
                   "--num", "8", "--batch", "4", "--out", str(out),
                   "--device", "cpu"])
    assert rc == 0
    rec = json.loads(out.read_text())
    assert rec["metric"] == "clip_fid"
    assert rec["n_real"] == rec["n_fake"] == 8
    assert rec["steps_trained"] == 3
    assert np.isfinite(rec["clip_fid"]) and rec["clip_fid"] >= 0
    assert rec["clip_is_real"] is False and rec["mock_reasons"]


@pytest.mark.parametrize("how", ["bare", "path"])
def test_resume(trained_folder, tmp_path, how, capsys):
    models, _ = trained_folder
    folder = tmp_path / "models"
    shutil.copytree(models, folder)
    want = folder / "model-1.ckpt"
    if how == "path":
        want = tmp_path / "elsewhere.ckpt"
        shutil.copy(folder / "model-1.ckpt", want)
    resume = ["--resume"] if how == "bare" else ["--resume", str(want)]
    rc = cli.main(["train", "--config", str(folder / "config.json"),
                   "--mock-data", "--batch-size", "8", "--steps", "2",
                   "--models", str(folder), "--results",
                   str(tmp_path / "results"), "--device", "cpu", *resume])
    assert rc == 0
    assert f"resuming from {want}" in capsys.readouterr().out
    # resumed at step 3: steps 3 and 4, saved at milestone 5 // 2 = 2
    saved = torch.load(folder / "model-2.ckpt", weights_only=True)
    assert saved["steps"] == 5


def test_train_requires_data():
    with pytest.raises(AssertionError, match="--data"):
        cli.main(["train", "--steps", "1", "--image-size", "16",
                  "--device", "cpu"])


def test_the_card_by_default(trained_folder, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    models, _ = trained_folder
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        cli.main(["generate", "--models", str(models), "--num", "1"])


def test_python_dash_m_runs_the_cli():
    proc = subprocess.run([sys.executable, "-m", "gigagan_tpu_torch",
                           "--help"], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for cmd in ("train", "train-upsampler", "generate", "evaluate",
                "upsample"):
        assert cmd in proc.stdout


def test_upsampler_cli_roundtrip(tmp_path):
    """train-upsampler for 1 step, then `upsample` a PNG: an 8² input as
    the net takes it, and a 12² one, resized to 8² (bilinear)."""
    cfg_path = tmp_path / "up.json"
    cfg_path.write_text(json.dumps(TINY_UP, default=list))
    models = tmp_path / "models"
    rc = cli.main(["train-upsampler", "--config", str(cfg_path),
                   "--mock-data", "--input-size", "8", "--image-size", "16",
                   "--batch-size", "8", "--steps", "1", "--models",
                   str(models), "--results", str(tmp_path / "results"),
                   "--device", "cpu"])
    assert rc == 0
    rng = np.random.default_rng(0)
    for size in (8, 12):
        low = tmp_path / f"low{size}.png"
        low.write_bytes(png.encode_png(
            rng.integers(0, 255, (size, size, 3), dtype=np.uint8)))
        out = tmp_path / f"high{size}.png"
        rc = cli.main(["upsample", "--models", str(models), "--input",
                       str(low), "--seed", "0", "--out", str(out),
                       "--device", "cpu"])
        assert rc == 0
        img = png.decode_png(out.read_bytes())
        assert img.shape == (16, 16, 3) and img.std() > 0


# ----------------------------------------------- a JAX-written model folder


@pytest.fixture
def jax_folder(tmp_path):
    folder = tmp_path / "jax_model"
    shutil.copytree(FIXTURES / "jax_model", folder)
    return folder


def jax_outputs():
    out = FIXTURES / "jax_outputs"
    noises = [np.load(p) for p in sorted(out.glob("noise_*.npy"))]
    return (np.load(out / "latents.npy"), noises, np.load(out / "g.npy"),
            np.load(out / "g_ema.npy"))


def port_generator_out(module, latents, noises):
    it = iter(noises)

    def hook(mod, args, kwargs):
        return args, dict(kwargs, noise=torch.from_numpy(next(it)))

    hooks = [m.register_forward_pre_hook(hook, with_kwargs=True)
             for m in module.modules() if isinstance(m, tl.Noise)]
    with torch.no_grad():
        out = module(noise=torch.from_numpy(latents))
    for h in hooks:
        h.remove()
    return out.numpy()


def test_jax_model_folder_gives_the_jax_outputs(jax_folder, tmp_path,
                                                monkeypatch):
    monkeypatch.setitem(sys.modules, "msgpack", None)
    out = tmp_path / "grid.png"
    rc = cli.main(["generate", "--models", str(jax_folder), "--num", "4",
                   "--seed", "0", "--out", str(out), "--device", "cpu"])
    assert rc == 0
    assert png.decode_png(out.read_bytes()).shape == (38, 38, 3)

    gan, ckpt = cli._load_model_folder(jax_folder, "cpu")
    assert ckpt.name == "model-1.ckpt" and gan.steps == 3
    latents, noises, g_want, g_ema_want = jax_outputs()
    for module, want in ((gan.G, g_want), (gan.G_ema, g_ema_want)):
        got = port_generator_out(module, latents, noises)
        assert got.shape == want.shape
        assert rel_err(got, want) <= JAX_OUT_TOL


@pytest.mark.parametrize("key,value,error", [
    ("checkpoint_backend", "pickle", ValueError),
    ("mixed_precision_type", "fp16", ValueError),
    ("mesh", [1, 2], ValueError),
])
def test_jax_only_keys_that_would_change_something_raise(jax_folder, key,
                                                         value, error):
    cfg_path = jax_folder / "config.json"
    cfg = json.loads(cfg_path.read_text())
    assert cfg["checkpoint_backend"] == "msgpack"  # accepted as written
    cfg_path.write_text(json.dumps({**cfg, key: value}))
    with pytest.raises(error, match=key):
        cli.main(["generate", "--models", str(jax_folder), "--device",
                  "cpu"])


# -------------------------------------------------------------------- PNG


def filtered_png(pixels, kind):
    """A PNG whose every row uses filter ``kind`` (a test-side encoder of
    the PNG specification's five filters)."""
    h, w, c = pixels.shape
    rows = pixels.reshape(h, w * c).astype(np.int32)
    out, prev = [], np.zeros(w * c, np.int32)
    for row in rows:
        left = np.concatenate([np.zeros(c, np.int32), row[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - up_left
            pa, pb, pc = (np.abs(p - x) for x in (left, prev, up_left))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, up_left))
        out.append(np.concatenate([[kind], (row - pred) & 0xFF]).astype(
            np.uint8))
        prev = row
    raw = np.stack(out).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    # two IDAT chunks, as encoders split long streams
    stream = zlib.compress(raw)
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                         0))
            + chunk(b"IDAT", stream[:len(stream) // 2])
            + chunk(b"IDAT", stream[len(stream) // 2:])
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_undoes_every_filter(tmp_path, kind, channels):
    pixels = np.random.default_rng(kind).integers(
        0, 256, (7, 9, channels), dtype=np.uint8)
    data = filtered_png(pixels, kind)
    np.testing.assert_array_equal(png.decode_png(data), pixels)
    try:
        from PIL import Image
    except ImportError:
        return
    path = tmp_path / "f.png"
    path.write_bytes(data)
    with Image.open(path) as img:  # the test encoder is a valid PNG
        want = np.asarray(img)
    np.testing.assert_array_equal(want.reshape(pixels.shape), pixels)


def test_png_reader_decodes_the_ports_grids(tmp_path):
    from gigagan_tpu_torch.train.trainer import save_image_grid

    images = np.random.default_rng(1).random((5, 8, 8, 3)).astype(
        np.float32)
    save_image_grid(images, tmp_path / "grid.png", nrow=2)
    grid = png.decode_png((tmp_path / "grid.png").read_bytes())
    assert grid.shape == (3 * 8 + 4 * 2, 2 * 8 + 3 * 2, 3)
    np.testing.assert_array_equal(grid[2:10, 2:10],
                                  (images[0] * 255).astype(np.uint8))
    np.testing.assert_allclose(png.read_image(tmp_path / "grid.png"),
                               grid / 255.0, rtol=0, atol=1e-7)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_reader_decodes_pil_pngs(tmp_path, mode):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(2)
    shape = {"L": (20, 13), "LA": (20, 13, 2), "RGB": (20, 13, 3),
             "RGBA": (20, 13, 4)}[mode]
    # smooth rows, so that PIL's adaptive filtering picks several filters
    pixels = (np.cumsum(rng.integers(0, 3, shape), axis=1) % 256).astype(
        np.uint8)
    path = tmp_path / "pil.png"
    Image.fromarray(pixels, mode).save(path)
    got = png.decode_png(path.read_bytes())
    np.testing.assert_array_equal(got.reshape(pixels.shape), pixels)
    with Image.open(path) as img:
        want = np.asarray(img.convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(png.read_image(path), want)


def test_png_reader_refuses_what_it_does_not_decode(tmp_path):
    data = bytearray(filtered_png(np.zeros((2, 2, 3), np.uint8), 0))
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data[:-5]) + b"\x00" + bytes(data[-4:]))
    header = struct.pack(">IIBBBBB", 2, 2, 16, 2, 0, 0, 0)
    sixteen = (png.SIGNATURE + struct.pack(">I", 13) + b"IHDR" + header
               + struct.pack(">I", zlib.crc32(b"IHDR" + header)))
    with pytest.raises(png.UnsupportedPNG):
        png.decode_png(sixteen + bytes(data[33:]))
