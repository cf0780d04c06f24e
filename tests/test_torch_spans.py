"""The port's phase spans (``gigagan_tpu_torch.utils.profiling.span``) as
``torch.profiler`` records them on the CPU: every span a trainer's
iteration or a ``generate`` call opens is recorded, lies inside its
iteration or request, and is a ``cpu_op`` event, not a user annotation
(Kineto mirrors user annotations onto the device's timeline, where a
trace reader would count them as device activity)."""

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gigagan_tpu_torch import GigaGAN  # noqa: E402
from gigagan_tpu_torch.data import (  # noqa: E402
    MockImageDataset,
    MockTextImageDataset,
)
from gigagan_tpu_torch.models import clip as tclip  # noqa: E402
from gigagan_tpu_torch.utils import SPANS, span  # noqa: E402
from gigagan_tpu_torch.utils import profiling  # noqa: E402

G_CFG = dict(image_size=16, dim_capacity=4, dim_max=32, dim_latent=16,
             style_network=dict(dim=16, depth=1), self_attn_resolutions=(),
             num_conv_kernels=2, num_skip_layers_excite=1,
             unconditional=True)
D_CFG = dict(image_size=16, dim_capacity=4, dim_max=32, attn_resolutions=(),
             num_skip_layers_excite=1, unconditional=True)
CLIP = dict(embed_dim=16, image_size=32, patch_size=8, vision_width=24,
            vision_layers=2, vision_heads=2, context_length=12,
            vocab_size=49408, text_width=16, text_layers=2, text_heads=2)
TE = dict(dim=16, depth=1, clip_dim=16)
G_TEXT = dict(G_CFG, style_network=dict(dim=16, depth=1, dim_text_latent=16),
              text_encoder=TE, cross_attn_resolutions=(8,),
              unconditional=False)
D_TEXT = dict(D_CFG, multiscale_input_resolutions=(8,), text_encoder=TE,
              unconditional=False)
VD_CFG = dict(clip_image_dim=24, clip_text_dim=16, layer_indices=(-1, -2),
              conv_dim=24, unconditional=False, num_conv_kernels=2)
TRAIN_PREFIXES = ("gigagan.train.", "gigagan.d.", "gigagan.g.")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traced(fn):
    """The ``gigagan.*`` events of a CPU profile of ``fn()``, as
    ``portbench/trace.py`` reads a profile: (start, end, name, event)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e)
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("gigagan.")]


def check_spans(events, root: str, outside=()) -> set:
    """Every event a known span, a host ``cpu_op`` and not a user
    annotation, on the CPU's timeline, and inside a ``root`` span (those
    named in ``outside`` outside every one); returns the names seen."""
    roots = [(s, e) for s, e, n, _ in events if n == root]
    assert roots, f"no {root} span"
    for s, e, n, ev in events:
        assert n in SPANS, n
        assert ev.activity_type() == "cpu_op", (n, ev.activity_type())
        assert not ev.is_user_annotation(), n
        assert ev.device_type() == DeviceType.CPU, n
        inside = any(r0 <= s and e <= r1 for r0, r1 in roots)
        assert inside != (n in outside), (
            f"{n} at [{s}, {e}]: inside a {root} is {inside}")
    return {n for _, _, n, _ in events}


def test_train_spans_nest_in_their_iteration(tmp_path):
    """Two iterations of an unconditional trainer with the chunked R1 on
    every step and a log step: every train span of SPANS is recorded, each
    inside an iteration, and the loader's wait inside the batch."""
    gan = GigaGAN(generator=G_CFG, discriminator=D_CFG, device="cpu",
                  seed=0, apply_gradient_penalty_every=1, gp_chunk=1,
                  log_steps_every=2, results_folder=tmp_path / "results",
                  model_folder=tmp_path / "models")
    gan.set_dataloader(MockImageDataset(16, length=8).get_dataloader(2))
    gan.steps = 2  # no first-step save; step 2 logs
    events = traced(lambda: gan.forward(steps=2))
    seen = check_spans(events, "gigagan.train.iteration",
                       outside={"gigagan.train.loader_close"})
    train = {n for n in SPANS if n.startswith(TRAIN_PREFIXES)}
    assert train <= seen, train - seen
    assert "gigagan.sync.batch_to_device" in seen
    assert not seen & {n for n in SPANS if n.startswith("gigagan.sample.")}
    counts = {n: sum(x[2] == n for x in events) for n in seen}
    assert counts["gigagan.train.iteration"] == 2
    assert counts["gigagan.train.log"] == 1
    assert counts["gigagan.train.loader_close"] == 1
    # one D and one G batch an iteration, each one wait on the loader
    assert counts["gigagan.train.batch"] == 4
    assert counts["gigagan.train.data_wait"] == 4
    batches = [(s, e) for s, e, n, _ in events if n == "gigagan.train.batch"]
    for s, e, n, _ in events:
        if n == "gigagan.train.data_wait":
            assert any(b0 <= s and e <= b1 for b0, b1 in batches)


def test_generate_spans_nest_in_their_request(tmp_path):
    gan = GigaGAN(generator=G_CFG, device="cpu", seed=0,
                  results_folder=tmp_path / "results",
                  model_folder=tmp_path / "models")
    events = traced(lambda: [gan.generate(batch_size=1, seed=s)
                             for s in range(2)])
    seen = check_spans(events, "gigagan.sample.request")
    assert {"gigagan.sample.request", "gigagan.sample.generator",
            "gigagan.sync.readback"} <= seen
    assert not any(n.startswith(TRAIN_PREFIXES) for n in seen)
    assert sum(n == "gigagan.sync.readback" for _, _, n, _ in events) == 2


@pytest.mark.parametrize("path", ["train", "generate"])
def test_clip_spans_of_a_conditional_trainer(tmp_path, path):
    """The text-conditioned trainer: CLIP's text embedding, its token copy
    and the vision-aided D's image normalisation, inside the iteration or
    the request that runs them."""
    clip = tclip.OpenClipAdapter(name=tclip.CLIPConfig(**CLIP), device="cpu")
    gan = GigaGAN(generator=G_TEXT, discriminator=D_TEXT,
                  vision_aided_discriminator=VD_CFG, clip=clip,
                  allow_mock_clip=True, device="cpu", seed=0,
                  log_steps_every=100, results_folder=tmp_path / "results",
                  model_folder=tmp_path / "models")
    gan.set_dataloader(MockTextImageDataset(16, length=8).get_dataloader(2))
    gan.steps = 2
    if path == "train":
        events = traced(lambda: gan.forward(steps=1))
        seen = check_spans(events, "gigagan.train.iteration",
                           outside={"gigagan.train.loader_close"})
        assert {"gigagan.clip.embed_texts", "gigagan.sync.clip_tokens",
                "gigagan.sync.clip_normalize",
                "gigagan.sync.clip_logit_scale"} <= seen
        # one embedding of each batch's captions, inside its batch
        batches = [(s, e) for s, e, n, _ in events
                   if n == "gigagan.train.batch"]
        embeds = [(s, e) for s, e, n, _ in events
                  if n == "gigagan.clip.embed_texts"]
        assert len(embeds) == len(batches) == 2
        assert all(any(b0 <= s and e <= b1 for b0, b1 in batches)
                   for s, e in embeds)
    else:
        events = traced(lambda: gan.generate(texts=["a cat", "a dog"],
                                             seed=3))
        seen = check_spans(events, "gigagan.sample.request")
        assert {"gigagan.clip.embed_texts", "gigagan.sync.clip_tokens",
                "gigagan.sample.generator", "gigagan.sync.readback"} <= seen


def test_span_is_the_shared_no_op_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert span("gigagan.train.iteration") is profiling._NO_SPAN
    assert span("gigagan.sync.readback") is span("gigagan.d.loss")
    with profile(activities=[ProfilerActivity.CPU]):
        on = span("gigagan.train.iteration")
        assert on is not profiling._NO_SPAN
        with on:
            pass


def test_span_names_are_unique_and_namespaced():
    assert len(SPANS) == len(set(SPANS))
    assert all(n.startswith("gigagan.") and " " not in n for n in SPANS)
    # what the benchmark's readers key on
    for name in ("gigagan.train.iteration", "gigagan.sample.request",
                 "gigagan.train.batch", "gigagan.train.data_wait",
                 "gigagan.train.d_step", "gigagan.train.g_step",
                 "gigagan.sample.generator"):
        assert name in SPANS
    assert sum(n.startswith("gigagan.sync.") for n in SPANS) >= 3
