"""The benchmark's plain float32 reference of the UNet upsampler
(``portbench/reference/unet_upsampler.py``, ``upsampler_trainer.py``)
against the port on the CPU at a tiny size of the ``upsampler-256``
configuration's shapes, and what the benchmark reads of the upsampler's
training: its spans (``gigagan.up.*``), the attribution of device time to
them (``portbench/attribution.py``), the three readers on it, the linear
attention's bound (``portbench/linattn_work.py``) and the check of G's
layers call by call (``portbench/layer_check.py``)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gigagan_tpu_torch import GigaGAN, ops  # noqa: E402
from gigagan_tpu_torch.models.unet_upsampler import (  # noqa: E402
    LinearAttention2D,
    UnetUpsampler,
)
from gigagan_tpu_torch.utils import SPANS  # noqa: E402
from portbench import (  # noqa: E402
    attribution,
    faults_backward,
    harness,
    kernel_work,
    layer_check,
    linattn_work,
    trace,
)
from portbench.drivers import train_upsampler  # noqa: E402
from portbench.reference import upsampler_trainer  # noqa: E402
from portbench.reference.unet_upsampler import linear_attend  # noqa: E402
from portbench.tests import tiny  # noqa: E402
from portbench.tests.tiny_upsampler import (  # noqa: E402
    LINEAR_ATTENTIONS,
    UP,
    train_cell,
)

ROOT = Path(__file__).resolve().parents[1]
# float32 on both sides, the same draws: only the order of the sums differs
TOL = 1e-4
UP_SPANS = ("gigagan.up.generator", "gigagan.up.linear_attn",
            "gigagan.up.lowres")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trainer(tmp_path, seed=0):
    gan = GigaGAN(generator=UP["generator"],
                  discriminator=UP["discriminator"], train_upsampler=True,
                  device="cpu", seed=seed,
                  model_folder=str(tmp_path / "models"),
                  results_folder=str(tmp_path / "results"))
    models = upsampler_trainer.make_weights(UP, 11, "cpu")
    gan.G.load_state_dict(models["G"].state_dict())
    gan.D.load_state_dict(models["D"].state_dict())
    return gan


def test_forward_and_rgbs_match_port():
    models = upsampler_trainer.make_weights(UP, 5, "cpu")
    ref = models["G"]
    port = UnetUpsampler(**UP["generator"])
    port.load_state_dict(ref.state_dict())
    gen = torch.Generator().manual_seed(3)
    lowres = torch.rand(2, 8, 8, 3, generator=gen)
    noise = torch.randn(2, 16, generator=gen)
    with torch.no_grad():
        want, want_rgbs = ref(lowres, noise=noise, return_all_rgbs=True)
        got, got_rgbs = port(lowres, noise=noise, return_all_rgbs=True)
    assert [t.shape for t in got_rgbs] == [t.shape for t in want_rgbs]
    assert [t.shape[1] for t in got_rgbs] == [8, 16, 32]
    for a, b in zip((got, *got_rgbs), (want, *want_rgbs)):
        gap = ((a - b).norm() / b.norm()).item()
        assert gap < TOL, gap


def test_weights_are_drawn_from_the_seed_and_load_into_the_port(tmp_path):
    a = upsampler_trainer.make_weights(UP, 5, "cpu")
    b = upsampler_trainer.make_weights(UP, 5, "cpu")
    c = upsampler_trainer.make_weights(UP, 6, "cpu")
    for key in ("G", "D"):
        sa, sb, sc = (m[key].state_dict() for m in (a, b, c))
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert any(not torch.equal(sa[k], sc[k]) for k in sa)
    gan = trainer(tmp_path)
    assert set(gan.G.state_dict()) == set(a["G"].state_dict())
    # the pixel shuffle starts as a nearest-neighbour upsample (ICNR)
    w = a["G"].ups[0].upsample.conv.weight
    assert torch.equal(w[0::4], w[3::4]) and not torch.equal(w[0], w[4])


def test_driver_readings_match_reference(tmp_path):
    numbers = train_upsampler.readings(tiny.context(train_cell(), tmp_path))
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert numbers[name][0] < TOL, (name, numbers[name])
    assert numbers["loss_gap.step2"][0] < TOL
    assert "grad_gap.G" in numbers and "change_gap.G_ema" in numbers
    # the layer check's replays of the adaptive convs and linear attentions
    for name in ("aconv_gap", "linattn_gap"):
        assert numbers[name][0] < TOL, (name, numbers[name])


def test_reference_loads_nothing_of_the_port():
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.unet_upsampler\n"
            "import portbench.reference.upsampler_trainer\n"
            "import portbench.linattn_work, portbench.attribution\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"gigagan_tpu_torch", "jax", "jaxlib", "flax",
                        "gigagan_tpu"}, names


def g_step(gan, reals):
    gan.train_generator_step(reals, calc_multiscale_loss=True, seed=7)
    return [p.grad.clone() for p in gan.G.parameters()], \
        {n: p.detach().clone() for n, p in gan.G.named_parameters()}


def test_profiled_g_step_records_spans_and_is_bitwise(tmp_path):
    reals = np.random.default_rng(0).random((1, 2, 32, 32, 3),
                                            dtype=np.float32)
    plain, traced = trainer(tmp_path), trainer(tmp_path)
    grads, params = g_step(plain, reals)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t_grads, t_params = g_step(traced, reals)
    assert all(torch.equal(a, b) for a, b in zip(grads, t_grads))
    assert all(torch.equal(params[n], t_params[n]) for n in params)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("gigagan.up.")]
    counts = {n: sum(e.name() == n for e in events) for n in UP_SPANS}
    modules = sum(isinstance(m, LinearAttention2D)
                  for m in traced.G.modules())
    assert modules == LINEAR_ATTENTIONS
    assert counts == {"gigagan.up.generator": 1,
                      "gigagan.up.linear_attn": LINEAR_ATTENTIONS,
                      "gigagan.up.lowres": 1}
    assert set(UP_SPANS) <= set(SPANS)
    for e in events:
        assert e.device_type() == DeviceType.CPU
        assert not e.is_user_annotation()
    gen = [e for e in events if e.name() == "gigagan.up.generator"][0]
    for e in events:
        if e.name() == "gigagan.up.linear_attn":
            assert gen.start_ns() <= e.start_ns()
            assert e.start_ns() + e.duration_ns() <= \
                gen.start_ns() + gen.duration_ns()


def graph_nodes(fn, *inputs) -> list:
    """The names of the autograd nodes ``fn`` adds between its inputs and
    its output, each node once."""
    out = fn(*inputs)
    stop = {t.grad_fn for t in inputs}
    seen, todo, names = set(), [out.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen or node in stop:
            continue
        seen.add(node)
        names.append(node.name())
        todo.extend(n for n, _ in node.next_functions)
    return names


def test_backward_link_finds_the_linear_attentions_nodes(tmp_path):
    """On a CPU profile of a g_step, the backward nodes linked to
    ``gigagan.up.linear_attn`` are those of ``linear_attend_fused``'s
    operators, every one of each call, and only those; all of them lie
    under the generator's span too."""
    reals = np.random.default_rng(0).random((1, 2, 32, 32, 3),
                                            dtype=np.float32)
    gan = trainer(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g_step(gan, reals)
    events = prof.profiler.kineto_results.events()
    _, links = attribution.host_links(events)

    def under(name):
        return [e for e in events if e.name().startswith(attribution.BACKWARD)
                and links[name][1].holds(e.start_thread_id(), e.start_ns())]

    found = under("gigagan.up.linear_attn")
    # q, k and v as the module makes them: views of one projection
    x = torch.randn(2, 4, 4, 48, requires_grad=True)
    qkv = [t.reshape(2, 16, 16) for t in (x * 1.0).chunk(3, dim=-1)]
    want = graph_nodes(
        lambda q, k, v: ops.linear_attend_fused(q, k, v, heads=2), *qkv)
    names = [e.name()[len(attribution.BACKWARD):].strip() for e in found]
    assert set(names) == set(want), set(names) ^ set(want)
    assert len(found) == LINEAR_ATTENTIONS * len(want)
    in_generator = under("gigagan.up.generator")
    assert {id(e) for e in found} <= {id(e) for e in in_generator}
    assert len(in_generator) > len(found)


class Event:
    """A stand-in of the profiler's ``_KinetoEvent``."""

    def __init__(self, name, start, end, *, tid=1, corr=0, linked=0,
                 seq=-1, fwd=0, device=DeviceType.CPU):
        self._v = dict(name=name, start_ns=start, duration_ns=end - start,
                       start_thread_id=tid, correlation_id=corr,
                       linked_correlation_id=linked, sequence_nr=seq,
                       fwd_thread_id=fwd, device_type=device)

    def __getattr__(self, key):
        return lambda: self._v[key]


def kernel(start, end, linked):
    return Event("a_kernel", start, end, linked=linked, corr=900 + start,
                 device=DeviceType.CUDA)


BW = attribution.BACKWARD
WINDOW = (1900, 3150)
EVENTS = [
    Event("gigagan.up.generator", 100, 500, corr=1),
    Event("aten::mm", 120, 150, corr=2, seq=10),
    Event("gigagan.up.linear_attn", 200, 300, corr=3),
    Event("aten::softmax", 210, 220, corr=4, seq=11),
    Event("aten::bmm", 230, 260, corr=5, seq=12),
    Event("cudaLaunchKernel", 235, 240, corr=5, linked=5),  # runtime
    Event("aten::add", 600, 610, corr=6, seq=13),
    Event(f"{BW} BmmBackward0", 1000, 1100, tid=2, corr=7, seq=12, fwd=1),
    Event("aten::bmm", 1010, 1090, tid=2, corr=8),
    Event(f"{BW} AddBackward0", 1200, 1300, tid=2, corr=9, seq=13, fwd=1),
    Event("aten::mul", 1210, 1290, tid=2, corr=10),
    Event(f"{BW} MmBackward0", 1400, 1500, tid=2, corr=11, seq=10, fwd=1),
    Event("aten::mm", 1410, 1490, tid=2, corr=12),
    # a node of another thread's operator with the same sequence number
    Event(f"{BW} MulBackward0", 1600, 1700, tid=2, corr=13, seq=11, fwd=3),
    Event("aten::mul", 1610, 1690, tid=2, corr=14),
    Event(trace.WINDOW, 1900, 3150, corr=15),
    Event(trace.WINDOW, 1900, 3150, device=DeviceType.CUDA, linked=15),
    kernel(1800, 2100, 2),    # mm, forward in the generator: 200 in window
    kernel(2100, 2150, 4),    # softmax in the linear attention: 50
    kernel(2150, 2350, 5),    # bmm in the linear attention: 200
    kernel(2350, 2400, 6),    # add, outside both
    kernel(2400, 2700, 8),    # the bmm's backward: 300 to both
    kernel(2700, 2800, 10),   # add's backward: neither
    kernel(2800, 2900, 12),   # mm's backward: the generator's, 100
    kernel(2900, 3000, 14),   # the other thread's node: neither
    kernel(3000, 3050, 0),    # unlinked
    kernel(3100, 3200, 2),    # cut by the window's end: 50
]
GEN_NS, LIN_NS = 200 + 50 + 200 + 300 + 100 + 50, 50 + 200 + 300


def summary_of(events, bound_s=None):
    device = [(max(e.start_ns(), WINDOW[0]),
               min(e.start_ns() + e.duration_ns(), WINDOW[1]), e.name(), True)
              for e in events if e.device_type() != DeviceType.CPU
              and e.name() != trace.WINDOW]
    s = trace.Summary(WINDOW, device, [])
    s.span_device_s = attribution.span_device_seconds(events, WINDOW)
    if bound_s is not None:
        s.linattn_bound_s = bound_s
    return s


def outcome(summary, kind="train"):
    return harness.Outcome(correct=True, attempted=4, failed=0, metrics={},
                           compared={}, device_peak_bytes=0, kind=kind,
                           units=4, trace=summary)


def read(metric, run):
    return harness.reader(metric).read(run)


def test_readers_on_synthetic_kernel_events():
    s = summary_of(EVENTS, bound_s=LIN_NS / 4 / 1e9)
    assert s.span_device_s == pytest.approx(
        {"gigagan.up.generator": GEN_NS / 1e9,
         "gigagan.up.linear_attn": LIN_NS / 1e9})
    busy = s.busy_s * 1e9
    assert busy == pytest.approx(3050 - 1900 + 3150 - 3100)
    run = outcome(s)
    assert read("up_g_share.train", run) == pytest.approx(
        100 * GEN_NS / busy)
    assert read("linattn_share.train", run) == pytest.approx(
        100 * LIN_NS / busy)
    assert read("linattn_roofline.train", run) == pytest.approx(25.0)


@pytest.mark.parametrize("case", ["base_summary", "parent", "sample",
                                  "no_trace", "no_bound"])
def test_readers_give_none_without_the_spans(case):
    """A run of another cell (the base driver's summary), a program without
    the spans (the parent), a sample run, an untraced run: None."""
    metrics = ("up_g_share.train", "linattn_share.train",
               "linattn_roofline.train")
    if case == "base_summary":
        run = outcome(trace.Summary(WINDOW, [(2000, 3000, "k", True)], []))
    elif case == "parent":
        run = outcome(summary_of([e for e in EVENTS
                                  if not e.name().startswith("gigagan.")],
                                 bound_s=1e-6))
    elif case == "sample":
        run = outcome(summary_of(EVENTS, bound_s=1e-6), kind="sample")
    elif case == "no_trace":
        run = outcome(None)
    else:
        run = outcome(summary_of(EVENTS))
        metrics = ("linattn_roofline.train",)
    assert all(read(m, run) is None for m in metrics)


def test_linear_attention_bound_is_the_same_whatever_implements_it():
    b, n, heads, d = 2, 64, 4, 8
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, n, heads * d, generator=gen,
                           requires_grad=True) for _ in range(3))
    with linattn_work.Recorder() as plain:
        ops.linear_attend_fused(q, k, v, heads=heads)
    original = ops.linear_attend_fused
    ops.linear_attend_fused = lambda q, k, v, *, heads, scale=None: \
        linear_attend(q, k, v, heads=heads, scale=scale or d ** -0.5)
    try:
        with linattn_work.Recorder() as other:
            ops.linear_attend_fused(q, k, v, heads=heads)
    finally:
        ops.linear_attend_fused = original
    assert ops.linear_attend_fused is original
    assert plain.calls == other.calls == 1
    assert plain.bound_s == other.bound_s
    # by hand: bytes-bound; 4 (b, n, H·d) fp32 tensors moved forward, 7
    # backward
    moved = 4 * b * n * heads * d
    assert plain.bound_s == pytest.approx(11 * moved / kernel_work.PEAK_BYTES)
    with linattn_work.Recorder() as no_grad, torch.no_grad():
        ops.linear_attend_fused(q, k, v, heads=heads)
    assert no_grad.bound_s == pytest.approx(4 * moved / kernel_work.PEAK_BYTES)
    big = torch.empty(8, 65536, 512, dtype=torch.bfloat16, device="meta")
    seconds, by = linattn_work.forward_bound(big, big, big, big, 8)
    assert by == "bytes" and seconds == pytest.approx(
        4 * big.numel() * 2 / kernel_work.PEAK_BYTES)


def test_reference_linear_attention_matches_port():
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 32, 16, generator=gen) for _ in range(3))
    want = linear_attend(q, k, v, heads=2, scale=8 ** -0.5)
    got = ops.linear_attend_fused(q, k, v, heads=2)
    assert ((got - want).norm() / want.norm()).item() < 1e-6


def recorded_calls(*, reference=False):
    """The layer check's calls of one forward and backward of the tiny G,
    the port's or the reference's."""
    models = upsampler_trainer.make_weights(UP, 5, "cpu")
    if reference:
        G = models["G"]
    else:
        G = UnetUpsampler(**UP["generator"])
        G.load_state_dict(models["G"].state_dict())
    lowres = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(2))
    with layer_check.Calls(reference=reference) as calls:
        G(lowres).square().mean().backward()
    return calls


def test_layer_check_records_the_calls_and_reads_rounding():
    calls = recorded_calls()
    assert len(calls.seen["linattn"]) == 3  # 8², 16² and 32² maps
    assert len(calls.seen["aconv"]) >= 3
    gaps = layer_check.gaps(calls, 7, under_test="program")
    assert set(gaps) == {"aconv_gap", "linattn_gap"}
    assert all(v < 1e-5 for v in gaps.values()), gaps
    # the reference's own calls in fp8, the control: far from rounding
    control = layer_check.gaps(recorded_calls(reference=True), 7,
                               under_test="fp8")
    assert all(v > 0.02 for v in control.values()), control


@pytest.mark.parametrize("fault,layer,size", [("k2-dw", "aconv", 0.1),
                                              ("linattn-dq", "linattn", 0.5)])
def test_layer_check_reads_a_fault_in_g_backward(fault, layer, size):
    calls = recorded_calls()
    faults_backward.FAULTS[fault](None)
    try:
        gaps = layer_check.gaps(calls, 7, under_test="program")
    finally:
        faults_backward.restore()
    assert gaps[f"{layer}_gap"] == pytest.approx(size, rel=0.05)
    others = {k: v for k, v in gaps.items() if k != f"{layer}_gap"}
    assert all(v < 1e-5 for v in others.values()), gaps
    assert ops.linear_attend_fused.__module__ == \
        "gigagan_tpu_torch.ops.attention"
