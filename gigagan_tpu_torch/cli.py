"""Command line (counterpart of gigagan_tpu/cli.py): train /
train-upsampler / generate / evaluate / upsample, with the JAX CLI's
flags, defaults and ``config.json`` contract.

- Every training subcommand accepts ``--config cfg.json``, a JSON object
  of ``GigaGAN(...)`` keyword arguments; flags override its entries.
- ``train`` writes the resolved config to ``<model_folder>/config.json``
  (on the main process), so that ``generate``, ``evaluate`` and
  ``upsample`` rebuild the model from the folder alone, with its latest
  ``model-N.ckpt``.  A folder written by ``python -m gigagan_tpu train``
  works too: its msgpack checkpoints and orbax checkpoint directories load
  through ``train/jax_checkpoint.py`` and ``train/orbax_checkpoint.py``.
  Of its JAX-only keys, ``checkpoint_backend`` ("msgpack" or "orbax": the
  port reads either and writes its own single-file checkpoints),
  ``mixed_precision_type="bf16"`` and ``mesh=None`` change nothing here
  and are accepted; another value raises.
- ``--device`` defaults to the card (``cuda:{LOCAL_RANK}`` under
  ``torchrun``); ``--device cpu`` runs on the CPU.
- ``--mock-data`` swaps the image folder for the mock dataset.
- Under ``torchrun --nproc-per-node N python -m gigagan_tpu_torch train
  ...`` the ranks train one model data-parallel; ``--batch-size`` is per
  process, as the JAX CLI's is per host.

Usage::

    python -m gigagan_tpu_torch train --data ./images --steps 10000 \\
        --batch-size 8 --grad-accum 4
    python -m gigagan_tpu_torch generate --models ./gigagan-models \\
        --num 16 --out samples.png
    python -m gigagan_tpu_torch evaluate --models ./gigagan-models \\
        --data ./images --num 256
    python -m gigagan_tpu_torch upsample --models ./up-models \\
        --input low.png --out high.png
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

CONFIG_NAME = "config.json"
# JAX-only GigaGAN keys and the values that change nothing in the port
_JAX_ONLY = {"checkpoint_backend": ("msgpack", "orbax"),
             "mixed_precision_type": ("bf16", "bfloat16"),
             "mesh": (None,)}


# --------------------------------------------------------------- helpers


def _deep_update(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_update(out[k], v)
        else:
            out[k] = v
    return out


def _load_config(path) -> dict:
    with open(path) as f:
        cfg = json.load(f)
    assert isinstance(cfg, dict), f"{path} must hold a JSON object"
    return cfg


def _default_train_config(args) -> dict:
    """The reference README quickstart shapes, sized by the flags (the JAX
    CLI's defaults)."""
    if args.cmd == "train-upsampler":
        generator = dict(
            style_network=dict(dim=64, depth=4),
            dim=32,
            image_size=args.image_size,
            input_image_size=args.input_size,
            unconditional=True,
        )
        discriminator = dict(
            dim_capacity=16,
            dim_max=512,
            image_size=args.image_size,
            num_skip_layers_excite=4,
            multiscale_input_resolutions=(args.image_size // 2,),
            unconditional=True,
        )
    else:
        generator = dict(
            dim_capacity=8,
            style_network=dict(dim=64, depth=4),
            image_size=args.image_size,
            dim_max=512,
            num_skip_layers_excite=4,
            unconditional=True,
        )
        discriminator = dict(
            dim_capacity=16,
            dim_max=512,
            image_size=args.image_size,
            num_skip_layers_excite=4,
            unconditional=True,
        )
    return dict(
        generator=generator,
        discriminator=discriminator,
        amp=True,
        train_upsampler=args.cmd == "train-upsampler",
    )


def _resolve_train_config(args) -> dict:
    cfg = _default_train_config(args)
    if args.config:
        cfg = _deep_update(cfg, _load_config(args.config))
    overrides = {}
    if args.models:
        overrides["model_folder"] = args.models
    if args.results:
        overrides["results_folder"] = args.results
    if args.lr is not None:
        overrides["learning_rate"] = args.lr
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.save_every is not None:
        overrides["save_and_sample_every"] = args.save_every
    if args.no_amp:
        overrides["amp"] = False
    if args.cmd == "train-upsampler":
        overrides["train_upsampler"] = True
    return _deep_update(cfg, overrides)


def port_kwargs(cfg: dict) -> dict:
    """A config's ``GigaGAN`` keyword arguments for the port: the JAX-only
    keys dropped where they change nothing, refused where they would."""
    out = dict(cfg)
    for key, accepted in _JAX_ONLY.items():
        if key not in out:
            continue
        value = out.pop(key)
        if value not in accepted:
            raise ValueError(f"{key}={value!r} has no counterpart in the "
                             f"port (accepted: {accepted})")
    return out


def _build_gan(cfg: dict, device):
    from gigagan_tpu_torch.train import GigaGAN

    return GigaGAN(**port_kwargs(cfg), device=device)


def _make_dataset(args, image_size: int):
    if args.mock_data:
        from gigagan_tpu_torch.data import MockImageDataset

        return MockImageDataset(image_size, seed=0)
    assert args.data, "--data FOLDER is required (or pass --mock-data)"
    from gigagan_tpu_torch.data import ImageDataset

    return ImageDataset(args.data, image_size,
                        augment_horizontal_flip=args.hflip)


def _checkpoints(folder: Path):
    """The folder's ``model-N.ckpt`` by N: the port's files, the JAX
    package's msgpack files and its orbax directories."""
    return sorted(folder.glob("model-*.ckpt"),
                  key=lambda p: int(p.stem.split("-")[-1]))


def _load_model_folder(models: str, device):
    """A trainer rebuilt from <models>/config.json and its latest
    checkpoint (the port's or the JAX package's)."""
    folder = Path(models)
    cfg_path = folder / CONFIG_NAME
    assert cfg_path.exists(), (
        f"{cfg_path} not found — `train` writes it; for external "
        "checkpoints pass --config with the GigaGAN kwargs"
    )
    cfg = _load_config(cfg_path)
    cfg["model_folder"] = str(folder)
    gan = _build_gan(cfg, device)
    ckpts = _checkpoints(folder)
    assert ckpts, f"no model-*.ckpt under {folder}"
    gan.load(ckpts[-1])
    return gan, ckpts[-1]


# ------------------------------------------------------------ subcommands


def _cmd_train(args):
    assert args.mock_data or args.data, (
        "--data FOLDER is required (or pass --mock-data)"
    )
    cfg = _resolve_train_config(args)
    gan = _build_gan(cfg, args.device)

    # the resolved config, so that generate/upsample rebuild the model
    # from the folder alone (tuples come back as lists)
    if gan.is_main:
        gan.model_folder.mkdir(parents=True, exist_ok=True)
        with open(gan.model_folder / CONFIG_NAME, "w") as f:
            json.dump(cfg, f, indent=2, default=list)

    if args.resume:
        path = args.resume
        if path == "auto":
            ckpts = _checkpoints(gan.model_folder)
            path = ckpts[-1] if ckpts else None
        if path is not None:
            gan.print(f"[gigagan_tpu_torch] resuming from {path}")
            gan.load(path)

    # full-resolution images: the upsampler's step makes its low-res input
    ds = _make_dataset(args, gan.G.image_size)
    gan.set_dataloader(ds.get_dataloader(args.batch_size))
    gan(steps=args.steps, grad_accum_every=args.grad_accum)
    return 0


def _cmd_generate(args):
    import numpy as np

    from gigagan_tpu_torch.train.trainer import save_image_grid

    gan, ckpt = _load_model_folder(args.models, args.device)
    assert not gan.train_upsampler, (
        "this model folder holds an upsampler — use `upsample`"
    )
    images = gan.generate(batch_size=args.num, seed=args.seed,
                          use_ema=not args.no_ema)
    out = args.out or "samples.png"
    save_image_grid(np.clip(images, 0.0, 1.0), out,
                    nrow=max(1, int(args.num ** 0.5)))
    print(f"[gigagan_tpu_torch] wrote {args.num} samples from {ckpt} -> "
          f"{out}")
    return 0


def _cmd_evaluate(args):
    """CLIP-FID of the EMA samples against a real set.  Pretrained
    features when a CLIP checkpoint is on disk (--clip,
    GIGAGAN_CLIP_CKPT or assets/); otherwise random-init CLIP, and the
    output says so through clip_is_real and mock_reasons."""
    import numpy as np

    from gigagan_tpu_torch.eval import QualityEvaluator
    from gigagan_tpu_torch.models.clip import OpenClipAdapter

    gan, ckpt = _load_model_folder(args.models, args.device)
    assert not gan.train_upsampler, (
        "evaluate samples the base generator; upsampler evaluation needs "
        "a lowres source — use `upsample` + your own metric loop"
    )
    clip_path = args.clip or os.environ.get("GIGAGAN_CLIP_CKPT")
    if not clip_path:
        default_asset = Path("assets/vit_b_32-laion400m_e32.pt")
        clip_path = str(default_asset) if default_asset.exists() else None
    ev = QualityEvaluator(OpenClipAdapter(pretrained=clip_path,
                                          device=gan.device),
                          batch_size=max(args.batch, 8))

    ds = _make_dataset(args, gan.G.image_size)
    reals = np.stack(
        [np.asarray(ds[i % len(ds)], np.float32) for i in range(args.num)]
    )
    fakes = []
    for i in range(0, args.num, args.batch):
        b = min(args.batch, args.num - i)
        fakes.append(np.clip(
            gan.generate(batch_size=b, seed=(args.seed or 0) + i,
                         use_ema=not args.no_ema),
            0.0, 1.0,
        ))
    result = {
        "metric": "clip_fid",
        "checkpoint": str(ckpt),
        "steps_trained": int(gan.steps),
        **ev.clip_fid(reals, np.concatenate(fakes)),
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


def _cmd_upsample(args):
    import numpy as np
    import torch

    from gigagan_tpu_torch.ops import resize_image_to
    from gigagan_tpu_torch.utils.png import encode_png, read_image

    gan, ckpt = _load_model_folder(args.models, args.device)
    assert gan.train_upsampler, (
        "this model folder holds a base generator — use `generate`"
    )
    lowres = torch.from_numpy(read_image(args.input))[None]
    size = gan.G.input_image_size
    if lowres.shape[1] != size or lowres.shape[2] != size:
        lowres = resize_image_to(lowres, size, "bilinear")
    out = gan.generate(lowres, seed=args.seed, use_ema=not args.no_ema)
    arr = (np.clip(out[0], 0.0, 1.0) * 255).astype(np.uint8)
    Path(args.out).write_bytes(encode_png(arr))  # bare image, no grid
    print(f"[gigagan_tpu_torch] upsampled {args.input} ({size} -> "
          f"{out.shape[1]}) via {ckpt} -> {args.out}")
    return 0


# ----------------------------------------------------------------- parser


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gigagan_tpu_torch",
        description="GigaGAN on CUDA: train, sample, evaluate, upsample.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device(parser):
        parser.add_argument(
            "--device", default=None,
            help="torch device (default: the CUDA device; cpu for tests)")

    def add_train(name, help_):
        t = sub.add_parser(name, help=help_)
        t.add_argument("--config", help="JSON file of GigaGAN kwargs")
        t.add_argument("--data", help="image folder")
        t.add_argument("--mock-data", action="store_true",
                       help="use the mock dataset (smoke runs)")
        t.add_argument("--hflip", action="store_true",
                       help="random horizontal flip augmentation")
        t.add_argument("--image-size", type=int, default=256)
        t.add_argument("--batch-size", type=int, default=8)
        t.add_argument("--grad-accum", type=int, default=1)
        t.add_argument("--steps", type=int, default=1000)
        t.add_argument("--lr", type=float, default=None)
        t.add_argument("--seed", type=int, default=None)
        t.add_argument("--save-every", type=int, default=None)
        t.add_argument("--no-amp", action="store_true",
                       help="full fp32 compute (default is bf16 amp)")
        t.add_argument("--models", default=None,
                       help="checkpoint folder (default ./gigagan-models)")
        t.add_argument("--results", default=None,
                       help="samples folder (default ./gigagan-results)")
        t.add_argument("--resume", nargs="?", const="auto", default=None,
                       help="resume from a checkpoint path, or the "
                            "latest in the model folder when bare")
        add_device(t)
        t.set_defaults(fn=_cmd_train)
        return t

    add_train("train", "train the base text/unconditional generator + D")
    t = add_train("train-upsampler", "train the UNet super-res upsampler")
    t.add_argument("--input-size", type=int, default=64,
                   help="lowres input resolution (default 64)")

    g = sub.add_parser("generate", help="sample a grid from a checkpoint")
    g.add_argument("--models", required=True,
                   help="model folder written by `train`")
    g.add_argument("--num", type=int, default=16)
    g.add_argument("--seed", type=int, default=None)
    g.add_argument("--no-ema", action="store_true",
                   help="sample the raw generator instead of EMA")
    g.add_argument("--out", default="samples.png")
    add_device(g)
    g.set_defaults(fn=_cmd_generate)

    e = sub.add_parser(
        "evaluate",
        help="CLIP-FID of EMA samples vs a real set (FID substitute)",
    )
    e.add_argument("--models", required=True,
                   help="model folder written by `train`")
    e.add_argument("--data", help="real-image folder")
    e.add_argument("--mock-data", action="store_true",
                   help="synthetic real set (smoke runs)")
    e.add_argument("--hflip", action="store_true", help=argparse.SUPPRESS)
    e.add_argument("--num", type=int, default=256,
                   help="samples per side of the Frechet fit")
    e.add_argument("--batch", type=int, default=8)
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--no-ema", action="store_true")
    e.add_argument("--clip", default=None,
                   help="CLIP torch checkpoint for real-feature metrics")
    e.add_argument("--out", default=None, help="also write the JSON here")
    add_device(e)
    e.set_defaults(fn=_cmd_evaluate)

    u = sub.add_parser("upsample", help="super-resolve an image file")
    u.add_argument("--models", required=True)
    u.add_argument("--input", required=True, help="lowres image file")
    u.add_argument("--seed", type=int, default=None)
    u.add_argument("--no-ema", action="store_true")
    u.add_argument("--out", default="upsampled.png")
    add_device(u)
    u.set_defaults(fn=_cmd_upsample)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
