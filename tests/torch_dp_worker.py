"""One rank of the data-parallel checks in tests/test_torch_parallel.py:
a gloo process group on the CPU, started by ``run`` in a spawned process
(this module imports no JAX, so a rank starts in seconds).  ``build`` and
``step_result`` also serve the single-process reference."""

import os

import numpy as np
import torch

TINY_CLIP = dict(embed_dim=16, image_size=32, patch_size=8, vision_width=24,
                 vision_layers=2, vision_heads=2, context_length=12,
                 vocab_size=49408, text_width=16, text_layers=2,
                 text_heads=2)
TE = dict(dim=16, depth=1, clip_dim=16)
G_UNCOND = dict(image_size=16, dim_capacity=4, dim_max=32, dim_latent=16,
                style_network=dict(dim=16, depth=1),
                self_attn_resolutions=(8,), self_attn_dim_head=8,
                self_attn_heads=2, cross_attn_resolutions=(),
                num_conv_kernels=2, unconditional=True)
D_UNCOND = dict(image_size=16, dim_capacity=4, dim_max=32,
                attn_resolutions=(8,), multiscale_input_resolutions=(8,),
                aux_recon_resolutions=(8,), num_conv_kernels=2,
                unconditional=True)
G_TEXT = dict(image_size=16, dim_capacity=4, dim_max=32, dim_latent=16,
              style_network=dict(dim=16, depth=1, dim_text_latent=16),
              text_encoder=TE, self_attn_resolutions=(),
              cross_attn_resolutions=(8,), num_conv_kernels=2,
              unconditional=False)
D_TEXT = dict(image_size=16, dim_capacity=4, dim_max=32, attn_resolutions=(),
              multiscale_input_resolutions=(8,), num_conv_kernels=2,
              unconditional=False, text_encoder=TE)
VD_TEXT = dict(clip_image_dim=24, clip_text_dim=16, layer_indices=(-1, -2),
               conv_dim=24, unconditional=False, num_conv_kernels=2)
CAPTIONS = ["a cat", "a dog on a mat", "red bird", "tall tree",
            "a boat", "two cups", "green hill", "the moon"]
GLOBAL_BATCH = 4  # per microbatch, over every rank


def build(kind, model_folder=None):
    from gigagan_tpu_torch import GigaGAN
    from gigagan_tpu_torch.models import clip as tclip

    kwargs = dict(diff_augment=dict(prob=1.0, horizontal_flip=True), seed=0,
                  device="cpu")
    if model_folder is not None:
        kwargs.update(model_folder=str(model_folder),
                      results_folder=str(model_folder))
    if kind == "uncond":
        return GigaGAN(generator=G_UNCOND, discriminator=D_UNCOND, **kwargs)
    clip = tclip.OpenClipAdapter(name=tclip.CLIPConfig(**TINY_CLIP), seed=0,
                                 device="cpu")
    return GigaGAN(generator=G_TEXT, discriminator=D_TEXT,
                   vision_aided_discriminator=VD_TEXT, clip=clip,
                   allow_mock_clip=True, **kwargs)


def global_batch(gan, kind, accum):
    """The global batch, (accum, GLOBAL_BATCH, ...); text-conditioned, a
    mapping with the captions' CLIP conditioning."""
    rng = np.random.default_rng(3)
    images = rng.random((accum, GLOBAL_BATCH, 16, 16, 3)).astype(np.float32)
    if kind == "uncond":
        return images
    with torch.no_grad():
        embeds, enc = gan.clip.embed_texts(
            CAPTIONS[:accum * GLOBAL_BATCH])
    return {"real_images": images,
            "text_encodings": enc.reshape(accum, GLOBAL_BATCH,
                                          *enc.shape[1:]),
            "text_embeds": embeds.reshape(accum, GLOBAL_BATCH, -1)}


def shard(batch, rank, world):
    """Rank ``rank``'s slice of every microbatch."""
    def cut(x):
        n = x.shape[1] // world
        return x[:, rank * n:(rank + 1) * n]
    if isinstance(batch, dict):
        return {k: cut(v) for k, v in batch.items()}
    return cut(batch)


def grads(module):
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()
            if p.grad is not None}


def step_result(kind, accum, rank=0, world=1):
    """A d_step with R1 and a g_step, each from the fresh state of seed 0
    on this rank's slice of the global batch (after a d_step, Adam's first
    update moves every weight by ±lr by its gradient's sign, which the
    order of the sums decides where a gradient is near 0): their losses,
    the gradients each optimizer stepped with, and checksums of the
    updated parameters."""
    from gigagan_tpu_torch import parallel

    out = {"checksum": []}
    for step in ("d", "g"):
        gan = build(kind)
        batch = shard(global_batch(gan, kind, accum), rank, world)
        if step == "d":
            losses = gan.train_discriminator_step(
                batch, grad_accum_every=accum, apply_gradient_penalty=True,
                calc_multiscale_loss=True, seed=11)
            out["D"] = grads(gan.D)
            if gan.VD is not None:
                out["VD"] = grads(gan.VD)
        else:
            losses = gan.train_generator_step(
                batch.shape[1] if kind == "uncond" else batch,
                grad_accum_every=accum, calc_multiscale_loss=True, seed=12)
            out["G"] = grads(gan.G)
        out[step] = {k: float(v) for k, v in losses.items()}
        out["checksum"].append(parallel.checksum(
            [*gan.G.parameters(), *gan.D.parameters()]))
    return out


def case_step(rank, world, kind, accum, out_dir):
    return step_result(kind, accum, rank, world)


def case_gather(rank, world, out_dir):
    """``losses.all_gather_batch``: the gathered value, and the gradient of
    this rank's loss Σ W_r ⊙ gathered summed over the ranks."""
    from gigagan_tpu_torch import losses

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((world, 3, 5)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((world, world * 3, 5)).astype(
        np.float32))
    mine = x[rank].clone().requires_grad_()
    gathered = losses.all_gather_batch(mine)
    (gathered * w[rank]).sum().backward()
    return {"value": gathered.detach(), "grad": mine.grad}


def case_save(rank, world, out_dir):
    """Every rank saves into a folder of its own: only rank 0 writes."""
    from pathlib import Path

    folder = Path(out_dir) / f"models-rank{rank}"
    gan = build("uncond", model_folder=folder)
    gan.save(folder / "model-0.ckpt")
    gan.num_samples = 2
    gan.save_sample(2)
    return {"files": sorted(p.name for p in folder.glob("*"))
            if folder.exists() else []}


def run(rank, world, port, case, args, out_dir):
    torch.set_num_threads(1)
    from gigagan_tpu_torch import parallel

    parallel.init("gloo", f"tcp://127.0.0.1:{port}", world, rank)
    try:
        result = CASES[case](rank, world, *args, out_dir)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


CASES = {"step": case_step, "gather": case_gather, "save": case_save}
