"""The readers of ``linattn_launches.sample`` and ``linattn_launches.train``
(the linear-attention kernel's device launches per request or iteration)
on hand-built traced windows: the kernels counted by their names, per
unit; None for a run of the other kind, a run without a trace or units,
and a program whose build list lacks the kernel (the parent of the change
that added it); their entries in BENCHMARK.json and their files."""

import json

import pytest

from gigagan_tpu_torch.ops.kernels import build
from portbench import harness, trace

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
METRICS = {"sample": "linattn_launches.sample",
           "train": "linattn_launches.train"}
# as the profiler names them: the anonymous namespace, the parameters
NAMES = ["(anonymous namespace)::linattn_context_kernel(__nv_bfloat16 "
         "const*, __nv_bfloat16 const*, long long, long long, long long, "
         "long long, int, int, int, float*, float*, float*)",
         "(anonymous namespace)::linattn_reduce_kernel(float const*, float "
         "const*, float const*, int, __nv_bfloat16*)",
         "(anonymous namespace)::linattn_out_kernel(__nv_bfloat16 const*, "
         "long long, long long, __nv_bfloat16 const*, __nv_bfloat16*, int, "
         "int, int, float)"]
OTHERS = ["void (anonymous namespace)::demod_scale_kernel<2, 9>(float "
          "const*, float const*, float const*, float*, int, int, int, int, "
          "int, int)", "void at::native::elementwise_kernel<128, 2>()",
          "fused_fwd_tc_kernel(CUtensorMap, int)", "linattn_contextual"]


def run_of(kind, names, units=2, traced=True):
    """An Outcome whose traced window holds one kernel per name."""
    device = [(10 * i, 10 * i + 5, n, True) for i, n in enumerate(names)]
    summary = trace.Summary((0, 10 * len(names) + 10), device, []) \
        if traced else None
    return harness.Outcome(correct=True, attempted=1, failed=0, metrics={},
                           compared={}, device_peak_bytes=0, kind=kind,
                           units=units, trace=summary)


def read(kind, run):
    return harness.reader(METRICS[kind]).read(run)


@pytest.mark.parametrize("kind", ["sample", "train"])
def test_counts_the_three_kernels_per_unit(kind):
    names = NAMES * 6 + OTHERS * 3
    assert read(kind, run_of(kind, names, units=1)) == 18.0
    assert read(kind, run_of(kind, names * 4, units=4)) == 18.0
    assert read(kind, run_of(kind, OTHERS, units=1)) == 0.0


@pytest.mark.parametrize("kind", ["sample", "train"])
@pytest.mark.parametrize("case", ["other_kind", "untraced", "no_units",
                                  "no_kernel"])
def test_reads_none_where_there_is_nothing_to_read(kind, case,
                                                   monkeypatch):
    other = "train" if kind == "sample" else "sample"
    run = run_of(other if case == "other_kind" else kind, NAMES * 6,
                 units=0 if case == "no_units" else 1,
                 traced=case != "untraced")
    if case == "no_kernel":
        monkeypatch.setattr(build, "KERNELS", tuple(
            k for k in build.KERNELS if k != "linear_attention"))
    assert read(kind, run) is None


def test_entries_and_files():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for kind, name in METRICS.items():
        m = entries[name]
        assert m["layer"] == "kernels" and m["source"] == "device_trace"
        assert m["moves"] == ("sample_ms_p50" if kind == "sample"
                              else "train_img_per_s")
        assert m["workloads"] == (["up-request-1024"] if kind == "sample"
                                  else ["up-train-b8"])
        assert (harness.PACKAGE / "metrics" / f"{name}.py").is_file()
