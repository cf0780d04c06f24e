#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gigagan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # the check, one card
    python3 chip_smoke.py --profile   # also a torch.profiler breakdown of
                                      # one batch-8 forward

Phases (any failure raises and exits non-zero):

1. find the card (fails without CUDA) and print its name and power limit;
2. build the CUDA kernels from ``gigagan_tpu_torch/csrc`` with nvcc;
3. hold kernel K1 (adaptive conv) against its plain PyTorch version at
   every 3x3 conv shape of the 256px generator, batch 8, fp32 (TF32 off)
   and bf16, and time both;
4. hold kernel K3 (fused-heads attention) against its plain version at
   both self-attention shapes, dot and L2, with the null key/value;
5. drive the main path: the README quickstart generator (256px, 30M
   params, bf16) answers generate(batch_size=8) and generate(batch_size=1)
   three times each; the kernels' launch counts must show 15 K1 and 2 K3
   launches per forward; one fp32 forward through the kernels is held
   against the plain path on the card; batch-1 latency and batch-8
   images/s are timed;
6. print the kernel table as one JSON line and, last, the device line.

Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"

# the README quickstart generator (bench.py / scripts/bench_infer.py)
QUICKSTART = dict(
    image_size=256,
    dim_capacity=8,
    dim_max=512,
    dim_latent=512,
    style_network=dict(dim=64, depth=4),
    num_skip_layers_excite=4,
    unconditional=True,
)
BATCH = 8
# the generator's default self-attention: 32² and 16² maps, 8 heads of 64
SELF_ATTN_RES, HEADS, DIM_HEAD = (32, 16), 8, 64
K1_TOL_F32, K1_TOL_BF16, K3_TOL = 0.02, 0.08, 0.03
G_TOL_F32 = 0.02


def log(msg):
    print(msg, flush=True)


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


def abs_err(got, want):
    return float((got.float() - want.float()).abs().max())


def time_ms(fn, torch, min_ms=60.0):
    """Mean device time of one call, CUDA events over a run of calls."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max(min_ms / once, 3), 200))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def path_convs(cfg):
    """(name, h, ci, co) of the generator's 3x3 adaptive convs."""
    from math import log2

    size = cfg["image_size"]
    num_layers = int(log2(size) - 1)
    res = [size // 2 ** i for i in reversed(range(num_layers))]
    dims = [min(2 ** (i + 1) * cfg["dim_capacity"], cfg["dim_max"])
            for i in range(num_layers)]
    dims = [cfg["dim_latent"], *reversed(dims)]
    convs = [("init_conv", 4, cfg["dim_latent"], cfg["dim_latent"])]
    for s, (r, di, do) in enumerate(zip(res, dims[:-1], dims[1:])):
        convs += [(f"stages.{s}.conv1", r, di, do),
                  (f"stages.{s}.conv2", r, do, do)]
    return convs


def main():
    import numpy as np
    import torch

    profile = "--profile" in sys.argv[1:]
    report = {}

    # ---------------------------------------------------------------- 1
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAIL: torch.cuda.is_available() is "
                         "false — this check runs on a CUDA device only")
    sys.path.insert(0, str(REPO))
    from gigagan_tpu_torch import GigaGAN, ops
    from gigagan_tpu_torch.models.layers import AdaptiveConv
    from gigagan_tpu_torch.ops.kernels import build, plain_reference
    from gigagan_tpu_torch.ops.kernels import adaptive_conv as k1
    from gigagan_tpu_torch.ops.kernels import flash_attention_fused as k3

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"gpu: {smi}")
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    report["gpu"] = smi
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    OUT_DIR.mkdir(exist_ok=True)

    # ---------------------------------------------------------------- 2
    ptxas = []
    for kname in ("adaptive_conv_fwd", "flash_attention_fused_fwd"):
        t0 = time.perf_counter()
        path, text = build.build(kname, verbose=True)
        log(f"build {kname}: {time.perf_counter() - t0:.2f} s -> "
            f"{path.relative_to(REPO)}")
        ptxas.append(text)
        build.load(kname)
    (OUT_DIR / "ptxas.log").write_text("\n".join(ptxas))
    for line in "\n".join(ptxas).splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---------------------------------------------------------------- 3
    gen = torch.Generator(device=dev).manual_seed(0)
    convs = path_convs(QUICKSTART)
    k1_rows = {}
    for _, h, ci, co in convs:
        if (h, ci, co) in k1_rows:
            continue
        x = torch.randn(BATCH, h, h, ci, device=dev, generator=gen)
        w = torch.randn(2, 3, 3, ci, co, device=dev, generator=gen) * (
            2.0 / (9 * ci)) ** 0.5
        a = torch.softmax(torch.randn(BATCH, 2, device=dev, generator=gen),
                          -1)
        scale_in = 1.0 + 0.2 * torch.randn(BATCH, ci, device=dev,
                                           generator=gen)
        d = ops.demod_scale(w, scale_in, a)
        xm = x * scale_in[:, None, None, :]
        want = k1.adaptive_conv_fwd_plain(xm, w, a, d)
        got32 = k1.adaptive_conv_fwd(xm, w, a, d)
        xb = xm.bfloat16()
        got16 = k1.adaptive_conv_fwd(xb, w, a, d)
        torch.cuda.synchronize()
        row = dict(
            h=h, ci=ci, co=co,
            rel_f32=rel_err(got32, want), rel_bf16=rel_err(got16, want),
            abs_f32=abs_err(got32, want), abs_bf16=abs_err(got16, want),
            ms_f32=time_ms(lambda: k1.adaptive_conv_fwd(xm, w, a, d), torch),
            plain_ms_f32=time_ms(
                lambda: k1.adaptive_conv_fwd_plain(xm, w, a, d), torch),
            ms_bf16=time_ms(lambda: k1.adaptive_conv_fwd(xb, w, a, d),
                            torch),
            plain_ms_bf16=time_ms(
                lambda: k1.adaptive_conv_fwd_plain(xb, w, a, d), torch),
        )
        k1_rows[(h, ci, co)] = row
        log(f"K1 b{BATCH} {h}x{h} {ci}->{co}: rel f32 {row['rel_f32']:.2e} "
            f"bf16 {row['rel_bf16']:.2e} | ms f32 {row['ms_f32']:.4f} "
            f"(plain {row['plain_ms_f32']:.4f}) bf16 {row['ms_bf16']:.4f} "
            f"(plain {row['plain_ms_bf16']:.4f})")
        if not (row["rel_f32"] <= K1_TOL_F32
                and row["rel_bf16"] <= K1_TOL_BF16):
            raise SystemExit(f"chip_smoke: FAIL: K1 disagrees at {row}")
    report["k1"] = list(k1_rows.values())

    # ---------------------------------------------------------------- 4
    heads, dh = HEADS, DIM_HEAD
    k3_rows = []
    for h in SELF_ATTN_RES:
        n = h * h
        for l2 in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.randn(BATCH, n, heads * dh, device=dev,
                                       generator=gen).to(dtype)
                           for _ in range(3))
                null_kv = torch.randn(2, heads, dh, device=dev,
                                      generator=gen)
                k_pre, bias, nk, nv, nb = k3.prep_fused(
                    k, v, null_kv, heads, l2, dh ** -0.5)
                args = (q, k_pre, v, bias, nk, nv, nb, heads)
                o_want, l_want = k3.flash_attention_fused_fwd_plain(*args)
                o_got, l_got = k3.flash_attention_fused_fwd(*args)
                torch.cuda.synchronize()
                row = dict(
                    n=n, heads=heads, d=dh, l2=l2,
                    dtype=str(dtype).split(".")[-1],
                    rel_out=rel_err(o_got, o_want),
                    rel_lse=rel_err(l_got, l_want),
                    abs_out=abs_err(o_got, o_want),
                    abs_lse=abs_err(l_got, l_want),
                    ms=time_ms(lambda: k3.flash_attention_fused_fwd(*args),
                               torch),
                    plain_ms=time_ms(
                        lambda: k3.flash_attention_fused_fwd_plain(*args),
                        torch),
                )
                k3_rows.append(row)
                log(f"K3 b{BATCH} n{n} H{heads} d{dh} l2={l2} "
                    f"{row['dtype']}: rel out {row['rel_out']:.2e} lse "
                    f"{row['rel_lse']:.2e} | ms {row['ms']:.4f} "
                    f"(plain {row['plain_ms']:.4f})")
                if not (row["rel_out"] <= K3_TOL
                        and row["rel_lse"] <= K3_TOL):
                    raise SystemExit(f"chip_smoke: FAIL: K3 disagrees at "
                                     f"{row}")
    report["k3"] = k3_rows

    # ---------------------------------------------------------------- 5
    t0 = time.perf_counter()
    gan = GigaGAN(generator=QUICKSTART, amp=True, device="cuda", seed=0)
    n_params = sum(p.numel() for p in gan.G.parameters())
    log(f"G: {n_params / 1e6:.2f}M params, built in "
        f"{time.perf_counter() - t0:.2f} s")
    seen = set()
    hooks = [
        m.register_forward_pre_hook(
            lambda mod, args: seen.add(
                (args[0].shape[1], *mod.weights.shape[-2:])))
        for m in gan.G_ema.modules()
        if isinstance(m, AdaptiveConv) and m.weights.shape[1] == 3
    ]

    k1.adaptive_conv_fwd.launches = 0
    k3.flash_attention_fused_fwd.launches = 0
    requests = [BATCH] * 3 + [1] * 3
    for i, bs in enumerate(requests):
        img = gan.generate(batch_size=bs, seed=i)
        size = QUICKSTART["image_size"]
        if img.shape != (bs, size, size, 3) or not np.isfinite(img).all():
            raise SystemExit(f"chip_smoke: FAIL: request {i} gave "
                             f"{img.shape} / non-finite values")
    launches = {"k1": k1.adaptive_conv_fwd.launches,
                "k3": k3.flash_attention_fused_fwd.launches}
    for hk in hooks:
        hk.remove()
    log(f"main path: {len(requests)} requests, launches {launches}")
    per_forward = {"k1": len(convs), "k3": len(SELF_ATTN_RES)}
    if launches != {k: n * len(requests) for k, n in per_forward.items()}:
        raise SystemExit(f"chip_smoke: FAIL: launch counts {launches}")
    if seen != set(k1_rows):
        raise SystemExit(f"chip_smoke: FAIL: path conv shapes {seen} != "
                         f"checked {set(k1_rows)}")

    gan32 = GigaGAN(generator=QUICKSTART, amp=False, device="cuda", seed=0)
    img_k = gan32.generate(batch_size=2, seed=7)
    with plain_reference():
        img_p = gan32.generate(batch_size=2, seed=7)
    img_amp = gan.generate(batch_size=2, seed=7)
    tt = torch.from_numpy
    g_rel = rel_err(tt(img_k), tt(img_p))
    amp_rel = rel_err(tt(img_amp), tt(img_p))
    log(f"G fp32 kernels vs plain path: rel {g_rel:.2e} (tol {G_TOL_F32}); "
        f"bf16 kernels vs fp32 plain: rel {amp_rel:.2e} (not gated)")
    report["g_rel_f32"], report["g_rel_amp"] = g_rel, amp_rel
    if not g_rel <= G_TOL_F32:
        raise SystemExit("chip_smoke: FAIL: G forward disagrees")

    def latency(bs, reps):
        times = []
        for i in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            gan.generate(batch_size=bs, seed=100 + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return statistics.median(times), times

    latency(1, 3)  # warm-up
    latency(BATCH, 3)
    lat1, lat1_all = latency(1, 25)
    lat8, lat8_all = latency(BATCH, 15)
    report["latency_b1_s"], report["latency_b1_all_s"] = lat1, lat1_all
    report["batch8_s"], report["batch8_all_s"] = lat8, lat8_all
    report["batch8_images_per_s"] = BATCH / lat8
    log(f"generate latency b1: {lat1 * 1e3:.3f} ms (median of 25, min "
        f"{min(lat1_all) * 1e3:.3f}); b{BATCH}: {lat8 * 1e3:.3f} ms (median "
        f"of 15, min {min(lat8_all) * 1e3:.3f}) -> {BATCH / lat8:.2f} "
        f"images/s [{smi}]")

    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof

        for bs in (BATCH, 1):
            with prof(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as p:
                torch.cuda.synchronize()
                t = time.perf_counter()
                gan.generate(batch_size=bs, seed=1)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
            events = p.key_averages()
            table = events.table(sort_by="self_device_time_total",
                                 row_limit=30)
            (OUT_DIR / f"profile_b{bs}.txt").write_text(table)
            dev = [e for e in events if e.device_type == DeviceType.CUDA]
            busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
            top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
            report[f"profile_b{bs}"] = dict(
                wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_kernels=sum(e.count for e in dev),
                top=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
                     for e in top])
            log(f"profile b{bs}: wall {wall_ms:.3f} ms, device busy "
                f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
                f"{sum(e.count for e in dev)} device kernels [{smi}]")
            for key, count, ms in report[f"profile_b{bs}"]["top"]:
                log(f"  {ms:9.3f} ms  x{count:<4d} {key}")

    # ---------------------------------------------------------------- 6
    mult = {}
    for _, h, ci, co in convs:
        mult[(h, ci, co)] = mult.get((h, ci, co), 0) + 1
    dot_bf16 = [r for r in k3_rows if not r["l2"] and r["dtype"] == "bfloat16"]
    kernels = [
        dict(
            name="adaptive_conv_fwd", route="cuda",
            source="gigagan_tpu_torch/csrc/adaptive_conv_fwd.cu",
            replaces="gigagan_tpu/ops/pallas/adaptive_conv.py:86",
            launches=launches["k1"],
            max_abs_err=max(max(r["abs_f32"], r["abs_bf16"])
                            for r in k1_rows.values()),
            ms=sum(mult[s] * r["ms_bf16"] for s, r in k1_rows.items()),
            plain_ms=sum(mult[s] * r["plain_ms_bf16"]
                         for s, r in k1_rows.items()),
        ),
        dict(
            name="flash_attention_fused_fwd", route="cuda",
            source="gigagan_tpu_torch/csrc/flash_attention_fused_fwd.cu",
            replaces="gigagan_tpu/ops/pallas/flash_attention_fused.py:95",
            launches=launches["k3"],
            max_abs_err=max(max(r["abs_out"], r["abs_lse"]) for r in k3_rows),
            ms=sum(r["ms"] for r in dot_bf16),
            plain_ms=sum(r["plain_ms"] for r in dot_bf16),
        ),
    ]
    report["kernels"] = kernels
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
