"""Remakes ``tests/torch_fixtures/jax_model``, ``jax_model_orbax`` and
``jax_outputs``: a model folder written by the JAX package's CLI (``python
-m gigagan_tpu train --mock-data``, 2 steps, at a tiny width), the same
trained state saved by the JAX trainer with ``checkpoint_backend="orbax"``,
and the generator's outputs for fixed latents and pixel noise, which the
port must reproduce from either folder alone (``tests/test_torch_cli.py``,
``tests/test_torch_orbax.py``; ``chip_smoke.py`` phase 16 on the card).

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_jax_model_folder.py
    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_jax_model_folder.py \
        --orbax-only   # jax_model_orbax from the jax_model already here

Writes ``jax_model/config.json`` and its latest ``model-N.ckpt`` (flax
msgpack); ``jax_model_orbax/config.json`` (the same, with
``"checkpoint_backend": "orbax"``) and ``model-N.ckpt``, an orbax
directory, written by a JAX ``GigaGAN(checkpoint_backend="orbax")`` that
loaded the msgpack checkpoint; and under ``jax_outputs/``:
``latents.npy``, one ``noise_NN.npy`` per Noise layer in call order,
``g.npy`` (the trained G) and ``g_ema.npy`` (its EMA), fp32.  The orbax
folder, loaded back by the JAX CLI, must give the recorded outputs
bitwise.
"""

import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
# the generator and discriminator of the fixture; the JAX-only keys the
# port accepts where they change nothing ride along
CONFIG = {
    "generator": {
        "image_size": 16, "dim_capacity": 2, "dim_max": 8,
        "dim_latent": 8, "style_network": {"dim": 8, "depth": 1},
        "self_attn_resolutions": [8], "self_attn_dim_head": 8,
        "self_attn_heads": 2, "cross_attn_resolutions": [],
        "num_skip_layers_excite": 2, "unconditional": True,
    },
    "discriminator": {
        "image_size": 16, "dim_capacity": 2, "dim_max": 8,
        "attn_resolutions": [8], "attn_dim_head": 8, "attn_heads": 2,
        "multiscale_input_resolutions": [8],
        "aux_recon_resolutions": [8], "unconditional": True,
    },
    "apply_gradient_penalty_every": 2,
    "log_steps_every": 10 ** 9,
    "early_save_thres_steps": 0,
    "num_samples": 4,
    "seed": 0,
    "checkpoint_backend": "msgpack",
    "mixed_precision_type": "bf16",
}
LATENT_SEED, NOISE_SEED, BATCH = 0, 1, 2


def g_outputs(gan, latents, noises=None):
    """{"g", "g_ema"}: the trained G's and its EMA's outputs for
    ``latents``, the pixel noise drawn from ``NOISE_SEED`` on the first
    pass (into ``noises``) or replayed from ``noises``."""
    import jax.numpy as jnp
    from flax import linen as nn

    from gigagan_tpu.models import layers as jl

    draw = noises is None
    noises = [] if draw else noises
    noise_rng = np.random.default_rng(NOISE_SEED)

    def interceptor(next_fun, args, kwargs, context):
        if (isinstance(context.module, jl.Noise)
                and context.method_name == "__call__"):
            if draw and len(noises) < n_layers[0]:  # the first pass draws
                x = args[0]
                noises.append(noise_rng.standard_normal(
                    (*x.shape[:-1], 1)).astype(np.float32))
            kwargs = dict(kwargs, noise=jnp.asarray(
                noises[calls[0] % len(noises)]))
            calls[0] += 1
        return next_fun(*args, **kwargs)

    n_layers, calls, out = [10 ** 9 if draw else len(noises)], [0], {}
    for name, params in (("g", gan.state.g_params),
                         ("g_ema", gan.state.ema.params)):
        with nn.intercept_methods(interceptor):
            y = gan.G.apply({"params": params}, noise=jnp.asarray(latents))
        n_layers[0] = len(noises)
        out[name] = np.asarray(y, np.float32)
    return out, noises


def write_orbax_folder():
    """``jax_model_orbax/`` from ``jax_model/``: its config with the orbax
    backend, and its latest checkpoint loaded into a JAX trainer of that
    config and saved by it; then checked against ``jax_outputs/``."""
    from gigagan_tpu import cli

    folder, orbax = HERE / "jax_model", HERE / "jax_model_orbax"
    outputs = HERE / "jax_outputs"
    shutil.rmtree(orbax, ignore_errors=True)
    orbax.mkdir()
    cfg = json.loads((folder / "config.json").read_text())
    cfg["checkpoint_backend"] = "orbax"
    (orbax / "config.json").write_text(json.dumps(cfg, indent=2))
    ckpt = sorted(folder.glob("model-*.ckpt"),
                  key=lambda p: int(p.stem.split("-")[-1]))[-1]
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            gan = cli._build_gan(dict(cfg, model_folder=str(orbax)))
            gan.checkpoint_backend = "msgpack"  # read the msgpack file
            gan.load(ckpt)
            gan.checkpoint_backend = "orbax"
            gan.save(orbax / ckpt.name)
            back, _ = cli._load_model_folder(str(orbax))
        finally:
            os.chdir(cwd)
    noises = [np.load(p) for p in sorted(outputs.glob("noise_*.npy"))]
    got, _ = g_outputs(back, np.load(outputs / "latents.npy"), noises)
    for name, y in got.items():
        assert np.array_equal(y, np.load(outputs / f"{name}.npy")), name


def main():
    sys.path.insert(0, str(REPO))
    if sys.argv[1:] == ["--orbax-only"]:
        write_orbax_folder()
        return report()
    from gigagan_tpu import cli

    folder, outputs = HERE / "jax_model", HERE / "jax_outputs"
    for d in (folder, outputs):
        shutil.rmtree(d, ignore_errors=True)
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            Path("cfg.json").write_text(json.dumps(CONFIG))
            rc = cli.main(["train", "--config", "cfg.json", "--mock-data",
                           "--image-size", "16", "--batch-size", "8",
                           "--steps", "2", "--save-every", "2", "--no-amp",
                           "--models", "jax_model", "--results", "results"])
            assert rc == 0
            ckpts = sorted(Path("jax_model").glob("model-*.ckpt"),
                           key=lambda p: int(p.stem.split("-")[-1]))
            for stale in ckpts[:-1]:
                stale.unlink()
            gan, _ = cli._load_model_folder("jax_model")
        finally:
            os.chdir(cwd)
        shutil.copytree(Path(tmp) / "jax_model", folder)

    outputs.mkdir()
    rng = np.random.default_rng(LATENT_SEED)
    latents = rng.standard_normal(
        (BATCH, CONFIG["generator"]["style_network"]["dim"])).astype(
        np.float32)
    np.save(outputs / "latents.npy", latents)
    got, noises = g_outputs(gan, latents)
    for name, y in got.items():
        np.save(outputs / f"{name}.npy", y)
    for i, n in enumerate(noises):
        np.save(outputs / f"noise_{i:02d}.npy", n)
    write_orbax_folder()
    report()


def report():
    dirs = [HERE / d for d in ("jax_model", "jax_model_orbax", "jax_outputs")]
    size = sum(p.stat().st_size for d in dirs
               for p in d.rglob("*") if p.is_file())
    print(f"wrote {', '.join(d.name for d in dirs)}: {size} bytes")


if __name__ == "__main__":
    main()
