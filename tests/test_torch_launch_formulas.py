"""chip_smoke.py's launch formulas against the kernel calls the train steps
make, counted on the CPU.

On the card ``chip_smoke.py`` holds every train step's K1-K7b launches to
``expected_step_launches`` (both R1 forms, gradient accumulation, the
chunked R1, ``remat`` and D's ``remat_stages``),
``expected_t2i_launches`` and ``expected_upsampler_launches``.  On the CPU
the kernel entries launch nothing (their ``.launches`` stay 0), but the
autograd Functions call the same dispatchers, which take the plain
versions there; each dispatcher is wrapped here, at the name the Functions
call it by, with a counter (the demodulation's, ``demod_scale_fwd``, at
the name ``ops.demod_scale`` calls it by, and the linear attention's,
``linear_attend_fwd``, at the name ``ops.linear_attend_fused`` calls it
by: every call that needs no gradient).  At these sizes every dispatch
is one launch on the card (two banks, batches far below the grid
limits), and every D attention is flash-sized (at least 256 queries and
128 keys), so that the forward-over-reverse R1 reaches K6a-K7b as at full
width."""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu_torch import GigaGAN  # noqa: E402
from gigagan_tpu_torch.models import clip as tclip  # noqa: E402
from gigagan_tpu_torch.models.layers import AdaptiveConv  # noqa: E402
from gigagan_tpu_torch.models.unet_upsampler import (  # noqa: E402
    Attention2D,
    LinearAttention2D,
)
from gigagan_tpu_torch.ops.kernels import adaptive_conv as k1  # noqa: E402
from gigagan_tpu_torch.ops.kernels import demod as kdemod  # noqa: E402
from gigagan_tpu_torch.ops.kernels import flash_attention_hv as k7  # noqa
from gigagan_tpu_torch.ops.kernels import flash_attention_so as so  # noqa
from gigagan_tpu_torch.ops.kernels import linear_attention as kla  # noqa

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# each kernel's dispatcher, where the autograd Functions look it up
DISPATCHERS = {"k1": (k1, "adaptive_conv_fwd"),
               "k2": (k1, "adaptive_conv_bwd_w"),
               "k3": (so, "flash_attention_fused_fwd"),
               "k4": (so, "flash_attention_fused_bwd"),
               "k5": (so, "flash_attention_so_bwd2"),
               "k6a": (k7, "flash_attention_fwd"),
               "k6b": (k7, "flash_attention_bwd"),
               "k7a": (k7, "flash_attention_hv_jvp"),
               "k7b": (k7, "flash_attention_hv_bwd"),
               "demod": (kdemod, "demod_scale_fwd"),
               "linattn": (kla, "linear_attend_fwd")}

BATCH = 2
# the quickstart's structure at 32px: G's 9 adaptive convs and one
# self-attention at 16²; D's attention at 32² and 16² (1024 and 256
# queries)
G_CFG = dict(image_size=32, dim_capacity=4, dim_max=32, dim_latent=16,
             style_network=dict(dim=16, depth=1), self_attn_resolutions=(16,),
             self_attn_dim_head=8, self_attn_heads=2, num_conv_kernels=2,
             num_skip_layers_excite=1, unconditional=True)
D_CFG = dict(image_size=32, dim_capacity=4, dim_max=32, attn_heads=2,
             attn_dim_head=8, num_skip_layers_excite=1, unconditional=True)
# text-to-image: tests/test_torch_conditional.py's tiny CLIP, text
# encoders in G and D, cross-attention in G at 8², a vision-aided D over
# two taps
CLIP = dict(embed_dim=16, image_size=32, patch_size=8, vision_width=24,
            vision_layers=2, vision_heads=2, context_length=12,
            vocab_size=49408, text_width=16, text_layers=2, text_heads=2)
TE = dict(dim=16, depth=1, clip_dim=16)
T2I_G = dict(G_CFG, style_network=dict(dim=16, depth=1, dim_text_latent=16),
             text_encoder=TE, cross_attn_resolutions=(8,),
             unconditional=False)
T2I_D = dict(D_CFG, text_encoder=TE, unconditional=False)
T2I_VD = dict(clip_image_dim=24, clip_text_dim=16, layer_indices=(-1, -2),
              conv_dim=24, unconditional=False, num_conv_kernels=2)
CAPTIONS = ["a cat", "a dog on a mat"]
# the upsampler: tests/test_torch_upsampler.py's small net, 8 -> 32
UP_G = dict(dim=8, image_size=32, input_image_size=8, dim_mults=(1, 2),
            full_attn=(False, True), cross_attn=(False, False),
            attn_depths=(1, 1), temporal_attn_depths=(1, 1),
            num_conv_kernels=2, unconditional=True,
            style_network=dict(dim=16, depth=1))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def counted(monkeypatch):
    """{kernel: calls of its dispatcher} while the test runs."""
    calls = dict.fromkeys(chip_smoke.KERNEL_NAMES, 0)
    for kname, (mod, name) in DISPATCHERS.items():
        def call(*operands, _kname=kname, _dispatch=getattr(mod, name),
                 **options):
            calls[_kname] += 1
            return _dispatch(*operands, **options)
        monkeypatch.setattr(mod, name, call)
    return calls


def launches(calls, step):
    """The dispatcher calls ``step()`` makes."""
    before = dict(calls)
    step()
    return {k: calls[k] - before[k] for k in calls}


def reals(n, size=32):
    return np.random.default_rng(0).random((n, size, size, 3)).astype(
        np.float32)


def d_attention(gan):
    return sum(st.core.attn is not None for st in gan.D.stages)


def test_d_attention_is_flash_sized():
    # the forward-over-reverse R1 reaches K6a-K7b only through a
    # flash-sized attend (ops/attention.py)
    gan = GigaGAN(generator=G_CFG, discriminator=D_CFG, device="cpu", seed=0)
    sizes = [st.resolution ** 2 for st in gan.D.stages
             if st.core.attn is not None]
    assert sizes == [1024, 256]
    assert len(chip_smoke.path_convs(G_CFG)) == sum(
        isinstance(m, AdaptiveConv) and m.weights.shape[1] == 3
        for m in gan.G.modules())


# (case, GigaGAN options, expected_step_launches options, R1 form): each
# case checks the d_step without R1, with R1 and the g_step, except the
# forward-over-reverse case, whose d_step+R1 is the formula's third row
STEP_CASES = {
    "reverse_over_reverse": ({}, {}, "ror"),
    "forward_over_reverse": (dict(gp_fwd_over_rev=True), {}, "for"),
    "accum2": ({}, dict(accum=2), "ror"),
    "chunks": (dict(gp_chunk=1), dict(chunks=BATCH), "ror"),
    "remat": (dict(remat=True), dict(remat=True), "ror"),
    "remat_stages": (dict(remat_stages=True), dict(remat_stages=True),
                     "ror"),
    "remat_and_remat_stages": (dict(remat=True, remat_stages=True),
                               dict(remat=True, remat_stages=True), "ror"),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_expected_step_launches(case, counted):
    options, formula, form = STEP_CASES[case]
    options = dict(options)
    d_cfg = dict(D_CFG, remat_stages=options.pop("remat_stages", False))
    gan = GigaGAN(generator=G_CFG, discriminator=d_cfg, device="cpu",
                  seed=0, **options)
    accum = formula.get("accum", 1)
    exp_d, exp_d_r1, exp_d_for, exp_g = chip_smoke.expected_step_launches(
        len(chip_smoke.path_convs(G_CFG)), *chip_smoke.attention_counts(gan),
        **formula)
    batch = reals(accum * BATCH).reshape(accum, BATCH, 32, 32, 3)

    def d_step(r1):
        return lambda: gan.train_discriminator_step(
            batch, grad_accum_every=accum, apply_gradient_penalty=r1,
            calc_multiscale_loss=True, seed=1)

    assert launches(counted, d_step(True)) == (
        exp_d_for if form == "for" else exp_d_r1)
    if form == "ror":
        assert launches(counted, d_step(False)) == exp_d
    assert launches(counted, lambda: gan.train_generator_step(
        BATCH, grad_accum_every=accum, calc_multiscale_loss=True,
        seed=2)) == exp_g


@pytest.fixture(scope="module")
def t2i_clip():
    return tclip.OpenClipAdapter(name=tclip.CLIPConfig(**CLIP), device="cpu")


@pytest.mark.parametrize("accum", [1, 2])
def test_expected_t2i_launches(accum, t2i_clip, counted):
    gan = GigaGAN(generator=T2I_G, discriminator=T2I_D,
                  vision_aided_discriminator=T2I_VD, clip=t2i_clip,
                  allow_mock_clip=True, device="cpu", seed=0)
    n_ga, n_da = chip_smoke.attention_counts(gan)
    assert n_da == 2
    exp = chip_smoke.expected_t2i_launches(
        len(chip_smoke.path_convs(T2I_G)), n_ga, n_da,
        *chip_smoke.t2i_structure(gan), accum=accum)
    embeds, encodings = t2i_clip.embed_texts(CAPTIONS * accum)
    batch = {"real_images": reals(accum * BATCH).reshape(
                 accum, BATCH, 32, 32, 3),
             "text_encodings": encodings.reshape(
                 accum, BATCH, *encodings.shape[1:]),
             "text_embeds": embeds.reshape(accum, BATCH, -1)}

    def d_step(r1):
        return lambda: gan.train_discriminator_step(
            batch, grad_accum_every=accum, apply_gradient_penalty=r1,
            calc_multiscale_loss=True, seed=1)

    assert launches(counted, d_step(False)) == exp[0]
    assert launches(counted, d_step(True)) == exp[1]
    gan.builder.gp_fwd_over_rev = True
    assert launches(counted, d_step(True)) == exp[2]
    assert launches(counted, lambda: gan.train_generator_step(
        batch, grad_accum_every=accum, calc_multiscale_loss=True,
        seed=2)) == exp[3]


def test_expected_upsampler_launches(counted):
    gan = GigaGAN(generator=UP_G, discriminator=D_CFG, train_upsampler=True,
                  device="cpu", seed=0)
    assert chip_smoke.upsampler_structure(UP_G) == (
        sum(isinstance(m, AdaptiveConv) for m in gan.G.modules()),
        sum(isinstance(m, Attention2D) for m in gan.G.modules()))
    assert chip_smoke.upsampler_linear_attentions(UP_G) == sum(
        isinstance(m, LinearAttention2D) for m in gan.G.modules())
    exp = chip_smoke.expected_upsampler_launches(UP_G, d_attention(gan))
    batch = reals(BATCH)

    def d_step(r1):
        return lambda: gan.train_discriminator_step(
            batch, apply_gradient_penalty=r1, calc_multiscale_loss=True,
            seed=1)

    assert launches(counted, d_step(False)) == exp[0]
    assert launches(counted, d_step(True)) == exp[1]
    gan.builder.gp_fwd_over_rev = True
    assert launches(counted, d_step(True)) == exp[2]
    assert launches(counted, lambda: gan.train_generator_step(
        batch, calc_multiscale_loss=True, seed=2)) == exp[3]


@pytest.mark.parametrize("net", ["quickstart", "upsampler"])
def test_generate_launches(net, counted):
    """An eager ``generate`` (the CPU never captures a graph): K1 and the
    demodulation once per G conv, the linear-attention kernel once per
    linear attention (none in the quickstart), no backward kernel."""
    if net == "quickstart":
        gan = GigaGAN(generator=G_CFG, device="cpu", seed=0)
        n_convs = len(chip_smoke.path_convs(G_CFG))
        n_linear = 0
        got = launches(counted, lambda: gan.generate(batch_size=BATCH,
                                                     seed=3))
    else:
        gan = GigaGAN(generator=UP_G, discriminator=D_CFG,
                      train_upsampler=True, device="cpu", seed=0)
        n_convs = chip_smoke.upsampler_structure(UP_G)[0]
        n_linear = chip_smoke.upsampler_linear_attentions(UP_G)
        assert n_linear == sum(isinstance(m, LinearAttention2D)
                               for m in gan.G_ema.modules()) > 0
        got = launches(counted, lambda: gan.generate(
            reals(BATCH, UP_G["input_image_size"]), seed=3))
    assert got["k1"] == got["demod"] == n_convs
    assert got["linattn"] == n_linear
    assert not any(got[k] for k in ("k2", "k4", "k5", "k6a", "k6b", "k7a",
                                    "k7b"))
