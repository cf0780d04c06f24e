"""The system under test, gigagan_tpu_torch, as the benchmark drives it:
its trainer built from a configuration with the benchmark's weights
loaded, the probes that read what its first steps produced (each step's
losses, the optimizers' state after the first step), the recorder of the
kernel entries' calls, and the entries' own launch counters."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from portbench import kernel_work

# the trainer keeps its defaults, except that no save or sample of its
# cadence falls inside a run
NO_SAVES = dict(save_and_sample_every=10 ** 9,
                early_save_and_sample_every=10 ** 9)


def clip_adapter(spec: dict, device):
    """The port's CLIP adapter of the configuration's ``clip`` entry (a
    named CLIP, its sizes optionally overridden), random weights and the
    hash tokenizer (its pretrained weights would have to be downloaded)."""
    from gigagan_tpu_torch.models.clip import CONFIGS, OpenClipAdapter

    sizes = {k: v for k, v in spec.items() if k != "name"}
    config = dataclasses.replace(CONFIGS[spec["name"]], **sizes)
    return OpenClipAdapter(name=config, device=device)


def build(config: dict, *, seed: int, device, out: Path,
          sampler: bool = False):
    """The port's ``GigaGAN`` of ``config``: a trainer, or with ``sampler``
    G alone (its EMA copy samples)."""
    from gigagan_tpu_torch import GigaGAN

    clip = clip_adapter(config["clip"], device) if config.get("clip") \
        else None
    kwargs = dict(generator=config["generator"], amp=config["amp"],
                  seed=seed, device=device, clip=clip,
                  allow_mock_clip=clip is not None,
                  model_folder=str(out / "models"),
                  results_folder=str(out / "results"), **NO_SAVES)
    if not sampler:
        kwargs.update(discriminator=config["discriminator"],
                      vision_aided_discriminator=config.get(
                          "vision_aided_discriminator"),
                      **config.get("trainer", {}))
    return GigaGAN(**kwargs)


@torch.no_grad()
def load_weights(gan, models: dict) -> None:
    """The benchmark's weights (the reference models' state) into the
    port's G, G_ema, D, VD and CLIP."""
    gan.G.load_state_dict(models["G"].state_dict())
    gan.G_ema.load_state_dict(models["G"].state_dict())
    if gan.D is not None:
        gan.D.load_state_dict(models["D"].state_dict())
    if gan.VD is not None:
        gan.VD.load_state_dict(models["VD"].state_dict())
    if gan.clip is not None:
        gan.clip.model.load_state_dict(models["clip"].state_dict())


def modules(gan) -> dict:
    """The trained modules by name, with their optimizers."""
    out = {"G": (gan.G, gan.g_opt), "D": (gan.D, gan.d_opt)}
    if gan.VD is not None:
        out["VD"] = (gan.VD, gan.vd_opt)
    return out


class Feed:
    """The loader as the trainer iterates it, keeping a copy of the first
    ``keep`` batches it hands out (images and captions), for the
    reference."""

    def __init__(self, loader, keep: int):
        self.loader = loader
        self.keep = keep
        self.batches = []

    def __iter__(self):
        for batch in self.loader:
            if len(self.batches) < self.keep:
                if isinstance(batch, tuple) and len(batch) == 2:
                    self.batches.append((batch[0].copy(), list(batch[1])))
                else:
                    images = batch[0] if isinstance(batch, tuple) else batch
                    self.batches.append((images.copy(), None))
            yield batch


def first_grad_norms(named, opt, beta1: float) -> dict:
    """Per leaf, the norm of the gradient the optimizer took at its first
    step, from Adam's first moment after it: m₁ = (1 − β₁)·g."""
    out = {}
    for name, p in named:
        state = opt.state.get(p, {})
        if "exp_avg" in state:
            out[name] = state["exp_avg"].float().norm() / (1.0 - beta1)
    return out


class StepProbe:
    """Records each step's losses (the metrics each step returns) and the
    per-leaf first gradients of every optimizer after its first step;
    ``close()`` takes the probes off."""

    def __init__(self, gan, mods: dict):
        self.gan = gan
        self.losses = []  # per step: {d_…, g_…} tensors
        self.first = {}
        self.handles = []
        d_step, g_step = gan.train_discriminator_step, \
            gan.train_generator_step

        def d_probe(*a, **k):
            out = d_step(*a, **k)
            self.losses.append({f"d_{n}": v for n, v in out.items()})
            return out

        def g_probe(*a, **k):
            out = g_step(*a, **k)
            self.losses[-1].update({f"g_{n}": v for n, v in out.items()})
            return out

        gan.train_discriminator_step = d_probe
        gan.train_generator_step = g_probe
        for key, (module, opt) in mods.items():
            named = list(module.named_parameters())
            beta1 = opt.param_groups[0]["betas"][0]

            def hook(o, args, kwargs, key=key, named=named, beta1=beta1):
                if key not in self.first:
                    self.first[key] = first_grad_norms(named, o, beta1)

            self.handles.append(opt.register_step_post_hook(hook))

    def close(self):
        del self.gan.train_discriminator_step
        del self.gan.train_generator_step
        for h in self.handles:
            h.remove()


def change_norms(named_now, state0: dict) -> dict:
    """Per leaf, ‖p − p₀‖ against the state dict ``state0``."""
    return {name: (p.detach().float() - state0[name].float()).norm()
            for name, p in named_now}


# the kernel entries, by family: (module, its tensor-core and CUDA-core
# entries)
ENTRIES = {
    "k1": ("gigagan_tpu_torch.ops.kernels.adaptive_conv",
           ("adaptive_conv_fwd_tc", "adaptive_conv_fwd_simt")),
    "k2": ("gigagan_tpu_torch.ops.kernels.adaptive_conv",
           ("adaptive_conv_bwd_w_tc", "adaptive_conv_bwd_w_simt")),
    "k3": ("gigagan_tpu_torch.ops.kernels.flash_attention_fused",
           ("flash_attention_fused_fwd_tc", "flash_attention_fused_fwd_simt")),
    "k4": ("gigagan_tpu_torch.ops.kernels.flash_attention_so",
           ("flash_attention_fused_bwd_tc", "flash_attention_fused_bwd_simt")),
    "k5": ("gigagan_tpu_torch.ops.kernels.flash_attention_so",
           ("flash_attention_so_bwd2_tc", "flash_attention_so_bwd2_simt")),
}


def launch_counters() -> dict:
    """The ``.launches`` counter of each K1-K5 entry."""
    import importlib

    out = {}
    for family, (mod, names) in ENTRIES.items():
        m = importlib.import_module(mod)
        for name in names:
            out[name] = getattr(m, name).launches
    return out


class CallRecorder:
    """While open, every call of a K1-K5 entry adds its bound (from its
    operands' and outputs' shapes, ``kernel_work``) to its family's sum.
    The entries count their own launches on themselves, so each wrapper
    carries the counter, and hands it back on close."""

    def __init__(self):
        self.bound_s = {f: 0.0 for f in ENTRIES}
        self.calls = {f: 0 for f in ENTRIES}
        self._saved = []

    def __enter__(self):
        import importlib

        for family, (mod, names) in ENTRIES.items():
            m = importlib.import_module(mod)
            for name in names:
                original = getattr(m, name)
                wrapper = self._wrap(family, original)
                wrapper.launches = original.launches
                setattr(m, name, wrapper)
                self._saved.append((m, name, original, wrapper))
        return self

    def _wrap(self, family, original):
        bound = kernel_work.BOUNDS[family]

        def entry(*args):
            out = original(*args)
            self.bound_s[family] += bound(args, out)[0]
            self.calls[family] += 1
            return out

        return entry

    def __exit__(self, *exc):
        for m, name, original, wrapper in self._saved:
            original.launches = wrapper.launches
            setattr(m, name, original)
        self._saved = []
        return False
