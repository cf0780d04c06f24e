"""The upsampler's request path as the benchmark's ``up-request-1024`` cell
drives it, on the CPU at a tiny size of its shapes (dim 8, 16² → 64²,
float32; the port runs its kernels' plain versions here): the port's
sampler-only ``GigaGAN(train_upsampler=True).generate(lowres, seed=s)``
against the plain reference (``portbench/reference/upsampler_sampler.py``),
its spans (``gigagan.sync.lowres_to_device`` among them), the four readers
the cell adds, the cell's files, and whole runs of its driver
(``portbench/drivers/sample_upsampler.py``) held to the cell's limits: a
sound run passes, a planted fault and the fp8 control fail."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gigagan_tpu_torch.models.unet_upsampler import (  # noqa: E402
    LinearAttention2D,
)
from gigagan_tpu_torch.utils import SPANS  # noqa: E402
from portbench import attribution, faults, harness, trace  # noqa: E402
from portbench.data import SeededImages  # noqa: E402
from portbench.drivers import sample_upsampler  # noqa: E402
from portbench.reference import upsampler_sampler  # noqa: E402
from portbench.tests import tiny  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELL = "up-request-1024"
# upsampler-1024's shapes at a tiny size: 64² from 16², three stages of
# which two skip their downsampling, linear attention at 16² (two down
# stages), 32² and 64², full attention at 16², 8² and the middle
TINY = {"generator": {"dim": 8, "image_size": 64, "input_image_size": 16,
                      "dim_mults": [1, 2, 4],
                      "full_attn": [False, False, True],
                      "cross_attn": [False, False, False],
                      "attn_depths": [1, 1, 1],
                      "temporal_attn_depths": [1, 1, 1],
                      "self_attn_heads": 2, "self_attn_dim_head": 8,
                      "cross_attn_dim_head": 8, "unconditional": True,
                      "style_network": {"dim": 16, "depth": 2}},
        "trainer": {"train_upsampler": True},
        "amp": False}
LINEAR_ATTENTIONS = 4
# float32 on both sides, the same weights, latent draw and input: only the
# order of the sums differs (the reference's grouped convs, its
# interpolations and its head-by-head attention against the port's plain
# versions)
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sampler(tmp_path_factory):
    """The port's sampler of TINY with the reference's weights of seed 5,
    and those reference models."""
    tmp = tmp_path_factory.mktemp("sampler")
    gan = sample_upsampler.build(TINY, seed=0, device="cpu", out=tmp)
    models = upsampler_sampler.make_weights(TINY, 5, "cpu")
    with torch.no_grad():
        gan.G.load_state_dict(models["G"].state_dict())
        gan.G_ema.load_state_dict(models["G"].state_dict())
    return gan, models


def lowres(index=0):
    return SeededImages(16, 3)[index][None]


def gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_the_sampler_has_no_discriminator_and_samples_its_ema_copy(sampler):
    gan, _ = sampler
    assert gan.train_upsampler and gan.D is None and gan.has_ema_generator
    assert sum(isinstance(m, LinearAttention2D)
               for m in gan.G_ema.modules()) == LINEAR_ATTENTIONS


@pytest.mark.parametrize("seed", [0, 2 ** 62 + 11])
def test_generate_matches_reference(sampler, seed):
    gan, models = sampler
    image = lowres()
    got = gan.generate(image, seed=seed)
    with torch.no_grad():
        want = upsampler_sampler.generate(models, seed, image).numpy()
    assert got.shape == want.shape == (1, 64, 64, 3)
    assert gap(got, want) < TOL, gap(got, want)


def test_reference_attention_head_by_head_is_the_fused_one():
    """The reference sampler's full attention, one head at a time, against
    ``reference/unet_upsampler.py``'s all heads at once."""
    models = upsampler_sampler.make_weights(TINY, 5, "cpu")
    attn = models["G"].mid_attn.attn_0
    x = torch.randn(1, 4, 4, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = attn(x)
        want = type(attn).forward(attn, x)
    assert attn.forward.__func__ is not type(attn).forward
    assert torch.allclose(got, want, rtol=0, atol=1e-6)


def test_reference_latent_is_the_draw_generate_makes(sampler):
    """The reference's latent of a seed is, bitwise, what the port's G
    feeds its style network in ``generate(lowres, seed=s)``."""
    gan, _ = sampler
    drawn = []
    hook = gan.G_ema.style_net.register_forward_pre_hook(
        lambda module, args: drawn.append(args[0].clone()))
    try:
        gan.generate(lowres(), seed=2 ** 62 + 5)
    finally:
        hook.remove()
    want = upsampler_sampler.latent(2 ** 62 + 5, 1, 16, "cpu")
    assert len(drawn) == 1 and torch.equal(drawn[0], want)
    assert not torch.equal(upsampler_sampler.latent(2 ** 62 + 6, 1, 16,
                                                    "cpu"), want)


def test_same_seed_repeats_bitwise_and_another_differs(sampler):
    gan, _ = sampler
    image = lowres(1)
    a = gan.generate(image, seed=7)
    b = gan.generate(image, seed=7)
    c = gan.generate(image, seed=8)
    assert np.array_equal(a, b)
    assert gap(c, a) > 0.01


def test_profiled_request_records_its_spans(sampler):
    gan, _ = sampler
    image = lowres(2)
    plain = gan.generate(image, seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = gan.generate(image, seed=3)
    assert np.array_equal(plain, traced)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("gigagan.")]
    counts = {}
    for e in events:
        assert e.name() in SPANS, e.name()
        assert e.device_type() == DeviceType.CPU
        assert not e.is_user_annotation()
        counts[e.name()] = counts.get(e.name(), 0) + 1
    assert counts == {"gigagan.sample.request": 1,
                      "gigagan.sample.generator": 1,
                      "gigagan.sync.lowres_to_device": 1,
                      "gigagan.up.generator": 1,
                      "gigagan.up.linear_attn": LINEAR_ATTENTIONS,
                      "gigagan.sync.readback": 1}
    by = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
          for e in events}
    copy, gen = by["gigagan.sync.lowres_to_device"], \
        by["gigagan.up.generator"]
    outer = by["gigagan.sample.generator"]
    # the copy lies in the request's generator phase, before the UNet
    assert outer[0] <= copy[0] and copy[1] <= gen[0] and gen[1] <= outer[1]


class Event:
    """A stand-in of the profiler's ``_KinetoEvent``."""

    def __init__(self, name, start, end, *, corr=0, linked=0, tid=1,
                 device=DeviceType.CPU):
        self._v = dict(name=name, start_ns=start, duration_ns=end - start,
                       start_thread_id=tid, correlation_id=corr,
                       linked_correlation_id=linked, sequence_nr=-1,
                       fwd_thread_id=0, device_type=device)

    def __getattr__(self, key):
        return lambda: self._v[key]


def kernel(name, start, end, linked):
    return Event(name, start, end, linked=linked, corr=900 + start,
                 device=DeviceType.CUDA)


WINDOW = (1000, 2000)
# one request's forward: a K1 call, a linear attention's two kernels, a K3
# call, all inside the generator's span; no backward (inference mode)
EVENTS = [
    Event("gigagan.up.generator", 100, 600, corr=1),
    Event("adaptive_conv_fwd_tc", 110, 150, corr=2),
    Event("gigagan.up.linear_attn", 200, 300, corr=3),
    Event("aten::softmax", 210, 220, corr=4),
    Event("aten::bmm", 230, 260, corr=5),
    Event("flash_attention_fused_fwd_tc", 400, 450, corr=6),
    Event("aten::add", 700, 710, corr=7),
    Event(trace.WINDOW, 1000, 2000, corr=8),
    kernel("conv_fwd_tc_kernel", 1000, 1200, 2),         # K1: 200
    kernel("softmax_kernel", 1200, 1300, 4),             # linear attn: 100
    kernel("gemm_kernel", 1300, 1600, 5),                # linear attn: 300
    kernel("fused_fwd_tc_kernel", 1600, 1850, 6),        # K3: 250
    kernel("elementwise_kernel", 1850, 1900, 7),         # outside both
]
LIN_NS, K1_NS, K3_NS = 400, 200, 250
CALLS = {"bound_s": {"k1": 50e-9, "k2": 0.0, "k3": 200e-9, "k4": 0.0,
                     "k5": 0.0},
         "calls": {"k1": 1, "k2": 0, "k3": 1, "k4": 0, "k5": 0}}
NEW = ("linattn_share.sample", "linattn_roofline.sample",
       "kconv_roofline.sample", "kattn_roofline.sample")


def summary_of(events, bound_s=None):
    device = [(max(e.start_ns(), WINDOW[0]),
               min(e.start_ns() + e.duration_ns(), WINDOW[1]), e.name(), True)
              for e in events if e.device_type() != DeviceType.CPU]
    s = trace.Summary(WINDOW, device, [])
    s.span_device_s = attribution.span_device_seconds(events, WINDOW)
    if bound_s is not None:
        s.linattn_bound_s = bound_s
    return s


def outcome(summary, kind="sample", calls=CALLS):
    return harness.Outcome(correct=True, attempted=3, failed=0, metrics={},
                           compared={}, device_peak_bytes=0, kind=kind,
                           units=1, trace=summary, calls=calls)


def read(metric, run):
    return harness.reader(metric).read(run)


def test_readers_on_synthetic_kernel_events():
    s = summary_of(EVENTS, bound_s=LIN_NS / 8 / 1e9)
    assert s.span_device_s["gigagan.up.linear_attn"] * 1e9 == \
        pytest.approx(LIN_NS)
    busy = s.busy_s * 1e9
    assert busy == pytest.approx(900)
    run = outcome(s)
    assert read("linattn_share.sample", run) == pytest.approx(
        100 * LIN_NS / busy)
    assert read("linattn_roofline.sample", run) == pytest.approx(12.5)
    assert read("kconv_roofline.sample", run) == pytest.approx(
        100 * 50 / K1_NS)
    assert read("kattn_roofline.sample", run) == pytest.approx(
        100 * 200 / K3_NS)


@pytest.mark.parametrize("case", ["train_run", "parent", "no_trace",
                                  "no_calls", "no_bound"])
def test_readers_give_none_without_their_spans(case):
    """A train run, a program without the spans, an untraced run, a run
    without recorded kernel calls (the base sample driver's), a window
    without the linear attention's bound: None."""
    metrics = NEW
    if case == "train_run":
        run = outcome(summary_of(EVENTS, bound_s=1e-7), kind="train")
    elif case == "parent":
        run = outcome(summary_of([e for e in EVENTS
                                  if not e.name().startswith("gigagan.")],
                                 bound_s=1e-7), calls={})
    elif case == "no_trace":
        run = outcome(None)
    elif case == "no_calls":
        run = outcome(summary_of(EVENTS, bound_s=1e-7), calls={})
        metrics = ("kconv_roofline.sample", "kattn_roofline.sample")
    else:
        run = outcome(summary_of(EVENTS))
        metrics = ("linattn_roofline.sample",)
    assert all(read(m, run) is None for m in metrics)


def test_the_cell_resolves():
    cell = harness.resolve(CELL)
    assert cell.chips == 1
    generator = cell.config["generator"]
    assert (generator["image_size"], generator["input_image_size"],
            generator["dim"]) == (1024, 256, 32)
    assert cell.config["trainer"] == {"train_upsampler": True}
    assert cell.config["amp"] is True
    assert cell.traffic == {"driver": "sample_upsampler", "batch": 1,
                            "lowres_size": 256}
    assert harness.driver(cell).run
    assert set(cell.limits) == {"pixel_median_gap", "image_median_gap",
                                "latent_gap"}
    assert all(v > 0 for v in cell.limits.values())
    assert [m["name"] for m in cell.end_to_end] == [
        "sample_ms_p50", "sample_ms_p95", "peak_mem_gib", "setup_s"]
    layer = {m["name"] for m in cell.per_layer}
    assert layer == {"launches.sample", "mfu.sample", "device_idle.sample",
                     "step_idle.sample", "syncs.sample",
                     "graph_share.sample", "demod_launches.sample", *NEW}
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]).read)
        if m["name"] in NEW:
            assert m["workloads"] == [CELL] and m["unit"] == "%"
            assert m["moves"] == "sample_ms_p50"


def test_reference_loads_nothing_of_the_port():
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.upsampler_sampler\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"gigagan_tpu_torch", "jax", "jaxlib", "flax",
                        "gigagan_tpu"}, names


def tiny_cell():
    return tiny.cell(TINY, {"driver": "sample_upsampler", "batch": 1,
                            "lowres_size": 16}, harness.resolve(CELL).limits)


def test_sound_run_passes(tmp_path):
    outcome = sample_upsampler.run(tiny.context(tiny_cell(), tmp_path,
                                                trace=True))
    assert outcome.correct, outcome.compared
    assert outcome.compared["latent_gap"][0] == 0.0
    assert outcome.kind == "sample" and outcome.metrics["sample_ms_p50"] > 0
    assert outcome.attempted >= 1 and outcome.flops_per_unit > 0
    # the traced window attributes the spans and records the kernel calls
    assert outcome.trace.linattn_calls == LINEAR_ATTENTIONS * outcome.units
    assert outcome.trace.linattn_bound_s > 0
    assert isinstance(outcome.trace.span_device_s, dict)
    assert outcome.calls is outcome.trace.calls
    assert set(outcome.calls["bound_s"]) == {"k1", "k2", "k3", "k4", "k5"}


@pytest.mark.parametrize("fault", ["altered", "other-latent"])
def test_planted_fault_fails(fault, tmp_path):
    """One altered pixel fails the pixel's number; the latent of another
    seed fails ``latent_gap`` (its effect on the images hides under bf16's
    rounding at the cell's widths: PERF.md §2)."""
    outcome = sample_upsampler.run(tiny.context(
        tiny_cell(), tmp_path, plant=faults.FAULTS[fault]))
    assert not outcome.correct, outcome.compared
    number = "pixel_median_gap" if fault == "altered" else "latent_gap"
    value, limit = outcome.compared[number]
    assert value > limit, outcome.compared


def test_control_fails(tmp_path):
    numbers = sample_upsampler.control(tiny.context(tiny_cell(), tmp_path))
    assert any(v > lim for v, lim in numbers.values()), numbers
    # the reference's own latent
    assert numbers["latent_gap"][0] == 0.0


def test_the_base_sample_driver_is_not_touched():
    from portbench.drivers import sample
    from portbench.reference import trainer
    from portbench.trace import Traced

    assert sample_upsampler.readings is not sample.readings
    assert sample.Traced is Traced and sample.ref_trainer is trainer
    assert sample.setup.__module__ == sample.__name__
    assert sample.reference_images.__module__ == sample.__name__
