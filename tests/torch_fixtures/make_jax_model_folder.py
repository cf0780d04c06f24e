"""Remakes ``tests/torch_fixtures/jax_model`` and ``jax_outputs``: a model
folder written by the JAX package's CLI (``python -m gigagan_tpu train
--mock-data``, 2 steps, at a tiny width) and its generator's outputs for
fixed latents and pixel noise, which the port must reproduce from the
folder alone (``tests/test_torch_cli.py``; ``chip_smoke.py`` phase 16 on
the card).

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_jax_model_folder.py

Writes ``jax_model/config.json`` and its latest ``model-N.ckpt`` (flax
msgpack), and under ``jax_outputs/``: ``latents.npy``, one
``noise_NN.npy`` per Noise layer in call order, ``g.npy`` (the trained
G) and ``g_ema.npy`` (its EMA), fp32.
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


def main():
    sys.path.insert(0, str(REPO))
    import jax.numpy as jnp
    from flax import linen as nn

    from gigagan_tpu import cli
    from gigagan_tpu.models import layers as jl

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
    noise_rng = np.random.default_rng(NOISE_SEED)
    noises = []

    def interceptor(next_fun, args, kwargs, context):
        if (isinstance(context.module, jl.Noise)
                and context.method_name == "__call__"):
            if len(noises) < n_layers[0]:  # the first pass draws
                x = args[0]
                noises.append(noise_rng.standard_normal(
                    (*x.shape[:-1], 1)).astype(np.float32))
            kwargs = dict(kwargs, noise=jnp.asarray(
                noises[calls[0] % len(noises)]))
            calls[0] += 1
        return next_fun(*args, **kwargs)

    n_layers, calls = [10 ** 9], [0]
    for name, params in (("g", gan.state.g_params),
                         ("g_ema", gan.state.ema.params)):
        with nn.intercept_methods(interceptor):
            out = gan.G.apply({"params": params},
                              noise=jnp.asarray(latents))
        n_layers[0] = len(noises)
        np.save(outputs / f"{name}.npy", np.asarray(out, np.float32))
    for i, n in enumerate(noises):
        np.save(outputs / f"noise_{i:02d}.npy", n)
    size = sum(p.stat().st_size for d in (folder, outputs)
               for p in d.rglob("*") if p.is_file())
    print(f"wrote {folder} and {outputs}: {size} bytes")


if __name__ == "__main__":
    main()
