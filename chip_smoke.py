#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gigagan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # the check, one card
    python3 chip_smoke.py --profile   # also torch.profiler breakdowns of one
                                      # batch-8 forward and of batch-8
                                      # training iterations (without R1,
                                      # with R1 in both forms)

Phases (any failure raises and exits non-zero):

1. find the card (fails without CUDA) and print its name and power limit;
2. build the CUDA kernels from ``gigagan_tpu_torch/csrc`` with nvcc, one
   process per source, all at once, and check in their SASS that the
   tensor-core K1, K2, K3, K4, K5, K7a and K7b run ``HGMMA`` (``wgmma``) fed
   by ``UTMALDG`` (TMA);
3. hold kernel K1 (adaptive conv) against its plain PyTorch version at
   every 3x3 conv shape of the 256px generator, batch 8: fp32 (TF32 off) on
   the CUDA-core kernel, bf16 with fp32 and with bf16 banks on the
   tensor-core one; and at extra rows (a ragged 12x20 map, 64 -> 48, with
   1 and 2 banks, and 4 banks as the conv pair's double backward makes);
   time the bf16 path shapes on both implementations, the plain version
   and cuDNN's grouped conv;
4. hold kernel K3 (fused-heads attention) against its plain version at the
   six attention shapes of the training path (G's dot product, D's L2 in
   the d_step and the g_step) with the null key/value, fp32 (CUDA-core
   kernel) and bf16 (tensor-core kernel), and at small ragged rows (300
   queries, 200 keys) for d = 64 and 128 (tensor cores in bf16) and 80
   (CUDA cores), with and without the null token, dot and L2; time the
   bf16 path shapes on both implementations, the plain version and one
   ``scaled_dot_product_attention`` call;
5. drive the sampling path: the README quickstart generator (256px, 30M
   params, bf16) answers generate(batch_size=8) and generate(batch_size=1)
   three times each; the kernels' launch counts must show 15 K1 and 2 K3
   launches per forward; one fp32 forward through the kernels is held
   against the plain path on the card; batch-1 latency and batch-8
   images/s are timed, with K1's CUDA-core kernel patched in on every
   other request as the yardstick;
6. hold K2 (weight gradient; fp32 on the CUDA-core kernel, bf16 on the
   tensor-core one, every bf16 launch checked to land there) and K1 as the
   input gradient (tensor cores in bf16), through the conv Function's
   backward, against plain PyTorch at the same 15 shapes, timing K2's two
   routes and the plain version beside the bound; K2 at extra rows (ragged
   12x20 maps at 16 -> 16, 16 -> 32, 32 -> 16 and 64 -> 48, the last on
   the CUDA cores by the rule; 1, 2 and 4 banks; batch 1), each launch on
   the route its rule names; and K2 at 8 banks (groups of at most 4 on the
   CUDA cores, 2 on the tensor cores);
7. the same for K4 (attention backward; the SDPA yardstick is its
   backward), and K5 (its adjoint; tensor cores in bf16 at d = 64) at the
   d_step's R1 shapes, timed beside its CUDA-core kernel, and at the small
   rows (ragged with and without the null token, dot and L2; d = 128 and
   80 on the CUDA cores);
8. hold K6a/K6b (split-heads attention and its backward; bf16 at d = 64
   and 128 on the tensor-core kernels of K3/K4 with one head, the rest on
   CUDA cores) and K7a/K7b (its jvp and the jvp's backward; bf16 at d = 64
   on their tensor-core kernels, the rest on CUDA cores) against their
   plain versions at the two attention shapes of the forward-over-reverse
   R1 surrogate (L2, the null token as an extra key), fp32 and bf16, and
   at small masked shapes (dot product, and head dims 128 and 80), each
   call on the route its rule names; all four also at a masked shape where
   one sample has every key masked, on both routes, whose outputs must be
   finite; time each kernel's two routes at φ's pair beside the plain
   versions (and SDPA for K6a/K6b);
9. drive the training path: the quickstart G+D pair (256px, bf16, batch 8)
   takes 8 iterations of train_discriminator_step + train_generator_step
   with R1 on iterations 0 and 4; every loss must be finite and every
   step's K1-K7b launch counts those the path implies (K5 on R1 steps
   only), every bf16 launch of a kernel with two routes on its tensor-core
   kernel; ms per
   d_step (with and without R1) and per g_step and images/s over the
   4-iteration cadence are timed;
10. the same 8 iterations with the R1 penalty taken forward-over-reverse
    (``GigaGAN(gp_fwd_over_rev=True)``): K6a, K6b, K7a and K7b on R1
    d_steps only, K5 never, every K6a-K7b launch on the tensor cores;
    d_step+R1 timed beside phase 9's;
11. fp32 steps on the card, each from the same fresh state: a d_step with
    R1 (both forms) and a g_step through the kernels against the same
    steps under ``plain_reference()`` (losses and every parameter's
    gradient), and the forward-over-reverse d_step against the
    reverse-over-reverse one (penalty and every gradient); then bf16: a
    d_step with R1 and a g_step through the tensor-core K3/K4 against the
    same steps with the CUDA-core ones patched in, the same for K1/K5, a
    g_step through the tensor-core K2 against the CUDA-core one, and a
    forward-over-reverse d_step with R1 through the tensor-core K6a/K6b,
    then K7a/K7b, against the CUDA-core ones; each bf16 route's distance
    from the fp32 plain step is reported, and the tensor-core route's may
    be at most FROM_PLAIN_RATIO times the CUDA-core route's;
12. the rest of the trainer at the quickstart's full width (bf16 unless
    named fp32): (a) 4 iterations with ``grad_accum_every=2`` (2
    microbatches of 4, R1 on one), finite losses and every step's launch
    counts those the path implies, every launch on the tensor cores; an
    fp32 accumulated d_step with R1 through the kernels against
    ``plain_reference()``; (b) the fp32 R1 penalty with ``gp_chunk=4`` at
    b = 8 and every D gradient against the unchunked step (no flips: the
    chunked penalty runs on the un-augmented pipeline); (c) fp32 d_step+R1
    and g_step gradients with ``remat`` and D's ``remat_stages`` against
    none, same seed (REMAT_TOL); then peak device memory and ms of
    d_step+R1 at microbatch 16 unchunked, with ``gp_chunk=8``, with
    ``remat_stages`` and with both recomputations, and of the g_step with
    and without (launch counts checked; the chunked peak must be lower);
    (d) ``train(24)`` with ``log_steps_every=8`` and a ``log_hook`` (JAX's
    record keys), both sample grids under ``chiprun_out/samples``, then
    ``save``, ``load`` into two fresh trainers (state equal), and one more
    iteration of each from the restored RNG (the continued and the resumed
    trainer within 3 times the distance of the two resumed copies, the
    card's own noise in the default mode, where cuDNN may pick algorithms
    that sum in any order); then the same resume in a child process
    (``--deterministic-resume``) under
    ``torch.use_deterministic_algorithms(True)`` with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: the continued trainer and two
    resumed copies bitwise equal after one more iteration, parameters and
    optimizer state alike, two upsampler trainers' steps from one seed
    bitwise equal, and nothing refused by the mode;
13. the text-to-image recipe of examples/train_text_to_image.py at full
    width (256px, batch 8, bf16; CLIP ViT-B/32 from seed 0 with the hash
    tokenizer, a 512-wide TextEncoder of depth 4 in G and D, cross-attention
    in G at 32² and 16², the vision-aided D over CLIP's last three taps,
    ``MockTextImageDataset`` images with eight distinct captions): 8
    iterations with R1 on 0 and 4, then 2 with R1 forward-over-reverse;
    every loss finite, the vision-aided, matching-aware, contrastive and R1
    terms non-zero, every step's K1-K7b launch counts those
    ``expected_t2i_launches`` names, every bf16 launch on the tensor
    cores; ms per step, images/s over the cadence and each step's peak
    memory; ``generate(texts=...)`` at batch 1 and 8 (latency, images/s,
    launch counts); fp32 d_steps (matching rows folded in; R1 in both
    forms) and a g_step against ``plain_reference()`` with its attention
    in float64 (losses and every D, VD or G gradient, 0.02; the plain fp32
    path's distance from it is reported as the control, and the q-side and
    k-side terms of D's shared-q/k ``to_q`` gradients); K1 and K2 at every shape and dtype the run and
    the sampling gave them (recorded at their dispatchers) against their
    plain versions, as called and in fp32, on the routes their rules name;
    the calls the generator does not make (the VD's 7x7 maps at 512
    channels, the predictors' rows at 32², 16², 8² and 4² for b, 2b and 4b
    images) timed;
14. the UNet upsampler recipe of examples/train_upsampler.py at full
    width (64 -> 256, dim 32, five stages, 47.89M-parameter G; its D reads
    G's rgbs at 128; batch 8, bf16, ``MockImageDataset(256, seed=0)``): 8
    iterations with R1 on 0 and 4, then 2 with R1 forward-over-reverse,
    every loss finite and every step's K1-K7b launch counts those
    ``expected_upsampler_launches`` derives from the configuration, every
    bf16 launch on the tensor cores; ms per step, images/s over the
    cadence and each step's peak memory; ``generate(lowres)`` at batch 1
    and 8 (46 K1 and 5 K3 per image) and a batch-1 256 -> 1024 request
    with the same widths (latency, peak memory); fp32 d_steps with R1 in
    both forms and a g_step against ``plain_reference()`` with float64
    attention (0.02); a video forward (4 frames, fp32, four stages) against
    the plain path, its 65536-row temporal attention split at K3's grid
    limit; K3, K4 and K5 at a batch of 65536 + 8 against their plain
    versions, two launches each; K1 and K2 at every shape and dtype of the
    run and the sampling against their plain versions, the bf16 shapes
    timed beside the plain version and cuDNN's grouped conv; K3/K4 at G's
    attention shapes beside SDPA;
15. print the kernel table as one JSON line (time, plain version, library
    call where one computes the same function, bound, launches on the
    text-to-image path, on the quickstart's and on the upsampler's) and,
    last, the device line.

Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback

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
# and its discriminator (bench.py:129-135)
QUICKSTART_D = dict(
    image_size=256,
    dim_capacity=16,
    dim_max=512,
    num_skip_layers_excite=4,
    unconditional=True,
)
BATCH = 8
# the text-to-image recipe of examples/train_text_to_image.py at its full
# width: CLIP ViT-B/32 (random weights from seed 0, the hash tokenizer), a
# 512-wide TextEncoder of depth 4 in G and in D, cross-attention in G at 32²
# and 16², and the vision-aided D over CLIP's last three visual taps
TEXT_ENCODER = dict(dim=512, depth=4, clip_dim=512)
T2I_G = dict(QUICKSTART, style_network=dict(dim=512, depth=4,
                                            dim_text_latent=512),
             text_encoder=TEXT_ENCODER, unconditional=False)
T2I_D = dict(QUICKSTART_D, text_encoder=TEXT_ENCODER, unconditional=False)
T2I_VD = dict(layer_indices=(-1, -2, -3), conv_dim=512, unconditional=False)
T2I_CAPTIONS = ["a cherry blossom tree", "a red sports car",
                "a bowl of fruit on a table", "a lighthouse at dusk",
                "two dogs in the snow", "a city skyline at night",
                "a sailing boat on a lake", "an owl on a branch"]
# the UNet upsampler recipe of examples/train_upsampler.py at its full
# width: 64 -> 256, dim 32, the default five stages (dim_mults (1, 2, 4, 8,
# 16), full attention at the two deepest, 2 kernel banks), a style network
# of dim 64 and depth 4; its D reads G's rgbs at 128
UPSAMPLER_G = dict(dim=32, image_size=256, input_image_size=64,
                   unconditional=True, style_network=dict(dim=64, depth=4))
UPSAMPLER_D = dict(QUICKSTART_D, multiscale_input_resolutions=(128,))
# the same widths for a 256 -> 1024 request (K1 on 1024² maps, K3 at 16384
# tokens), and the video net: five stages pool time three times, which
# takes 4 frames to none (in JAX too), so the video forward cuts the depth
# to four stages (4 frames -> 1 at the middle -> 16 out, the last up
# stage's temporal attention on 256² = 65536 rows of 16 frames)
UPSAMPLER_1K = dict(UPSAMPLER_G, image_size=1024, input_image_size=256)
UPSAMPLER_VIDEO = dict(UPSAMPLER_G, has_temporal_layers=True,
                       dim_mults=(1, 2, 4, 8),
                       full_attn=(False,) * 3 + (True,),
                       cross_attn=(False,) * 4, attn_depths=(1,) * 4,
                       temporal_attn_depths=(1,) * 4)
VIDEO_FRAMES, VIDEO_TOL = 4, 0.02
# phase 14: the fp32 steps' batch, and the batch past K3-K5's grid limit
UP_FP32_BATCH, SPLIT_ROWS = 4, 65536 + 8
# the generator's default self-attention: 32² and 16² maps, 8 heads of 64
SELF_ATTN_RES, HEADS, DIM_HEAD = (32, 16), 8, 64
K1_TOL_F32, K1_TOL_BF16, K3_TOL = 0.02, 0.08, 0.03
# K1's extra rows (b, h, w, ci, co, banks): a ragged map, one bank, and the
# 2n = 4 banks of the conv pair's double backward
K1_EXTRA = [(2, 12, 20, 64, 48, 2), (2, 12, 20, 64, 48, 1),
            (2, 9, 13, 32, 64, 4)]
K2_TOL_F32, K2_TOL_BF16, K4_TOL, K5_TOL = 0.02, 0.08, 0.03, 0.05
# a bf16 K2 call against the plain version on the same bf16 inputs: both
# sum the same products in fp32, only the order differs (every row read
# within 2e-6 on an H100), so a lost chunk of pixels (1/1024 of a 256²
# map's sum per sample) stands far above this
K2_TOL_SAME = 1e-4
G_TOL_F32, STEP_TOL_F32, STEP_TOL_BF16 = 0.02, 0.02, 0.08
# a gradient leaf that moves by more than this in fp32 when only the order
# of summation changes (kernels vs plain path, same step) carries no
# information at bf16's 2^16 times coarser rounding: the bf16 comparison of
# the two K3/K4 routes reports it and holds the other leaves to 0.08
STABLE_F32 = 1e-3
# The fp32 reading of a few ill-conditioned leaves of G sits at the edge
# of STABLE_F32 and moved across it once the resample backwards stopped
# summing with atomics in any order; they stay out of the bf16 gate, as
# they were while those backwards used atomics.  Noise weights: each
# gradient contracts the upstream gradient with the step's N(0, 1) pixel
# noise over every pixel, a sum that cancels to about 1/sqrt(pixels) of
# its terms (fp32 1.13e-3 to 1.14e-2 before, 7.7e-4 to 9.6e-3 after; bf16
# 0.02-0.34 before and 0.02-0.55 after between the two K3/K4 or K1/K5
# routes).  The
# style network's weight matrices and first bias sum the modulation
# gradients of every conv (fp32 1.05e-3 to 1.72e-3 before, 7.8e-4 to
# 1.5e-3 after; bf16 0.05-0.14 before, 0.06-0.19 after).  Measured on an
# H100 at phase 11's g_steps.
NOISE_WEIGHT = re.compile(r"\.noise\d+\.weight$")
STYLE_NET_UNRESOLVED = re.compile(
    r"^style_net\.(linear_\d+\.weight|linear_0\.bias)$")


def informative(name, rel_f32):
    """Whether a gradient leaf that moved by `rel_f32` in fp32 (kernels vs
    plain path) is held to the bf16 limit."""
    return (rel_f32 <= STABLE_F32 and not NOISE_WEIGHT.search(name)
            and not STYLE_NET_UNRESOLVED.match(name))


# the training path's attention (batch, tokens, L2 similarity?): G's dot
# product at batch 8; D's L2 in the d_step on the [real; fake] batch of
# 16 grown by the multiscale groups (×4 at 32², ×8 at 16²), and in the
# g_step on the 8 fakes
ATTN_PATH = [
    ("G", 8, 1024, False), ("G", 8, 256, False),
    ("D d_step", 64, 1024, True), ("D d_step", 128, 256, True),
    ("D g_step", 32, 1024, True), ("D g_step", 64, 256, True),
]
R1_ATTN = [row for row in ATTN_PATH if row[0] == "D d_step"]
# small rows for the other branches: ragged nq != nk, and head dims 128
# (tensor cores in bf16) and 80 (CUDA cores), each with and without the null
# token, dot and L2: (who, b, heads, nq, nk, d)
ATTN_SMALL = [("ragged", 2, 2, 300, 200, 64), ("d128", 2, 2, 300, 200, 128),
              ("d80", 1, 3, 260, 131, 80)]
# the forward-over-reverse surrogate's attention: D's L2 self-attention on
# split heads, (b, heads, queries, keys with the null token, head dim); and
# small masked cases for the kernels' other branches, among them the
# wider heads (64 < d <= 128) a D built with attn_dim_head > 64 runs
HV_PATH = [("phi", 64, HEADS, 1024, 1025, DIM_HEAD, True, False),
           ("phi", 128, HEADS, 256, 257, DIM_HEAD, True, False),
           ("masked dot", 2, 2, 300, 200, DIM_HEAD, False, True),
           ("masked L2 d128", 2, 2, 300, 200, 128, True, True),
           ("masked dot d80", 1, 3, 260, 131, 80, False, True)]
# K6a/K6b where sample 0 has every key masked (NEG_INF in its whole bias
# row): the plain version gives the mean of v, lse = NEG_INF and, from that
# lse, P = 1 at every key; both routes must give it, finite
K6_ALL_MASKED = ("all masked", 2, 2, 300, 200, DIM_HEAD, False, "all")
# K2 with more banks than one launch takes (b, h, ci, co, banks)
K2_BANKS = (BATCH, 32, 128, 128, 8)
# K2's extra rows (b, h, w, ci, co, banks): ragged maps at the thin layers'
# channel counts and ci != co both ways, 64 -> 48 (three 16-wide co tiles)
# and 64 -> 40 (the CUDA cores by the rule), one bank, four banks (two
# tensor-core launches), batch 1
K2_EXTRA = [(2, 12, 20, 16, 16, 2), (2, 12, 20, 16, 32, 2),
            (2, 12, 20, 32, 16, 2), (2, 12, 20, 64, 48, 2),
            (2, 12, 20, 64, 40, 2), (2, 12, 20, 16, 16, 1),
            (2, 9, 13, 32, 64, 4), (1, 16, 16, 32, 16, 2)]
# fp32 rows read at most 1.6e-4 and bf16 rows at most 6.7e-3 on an H100
K67_TOL_F32, K67_TOL_BF16 = 1e-3, 0.03
# phase 11: a bf16 step's tensor-core route may sit at most this many times
# as far from the fp32 plain step as its CUDA-core route; every route read
# 7.75e-2 to 9.53e-2 from it on an H100, so 1.5 leaves room for noise and
# still catches a route that drifts
FROM_PLAIN_RATIO = 1.5
ITERATIONS, R1_EVERY = 8, 4
# phase 12: microbatches of the accumulation run, the R1 chunk at b = 8, the
# microbatch of the memory rows and its chunk; fp32 gradients with and
# without recomputation differ only by the order of the backward's atomic
# sums (the recomputed forward is the same arithmetic on the same draws)
ACCUM, CHUNK, MEM_BATCH, MEM_CHUNK, REMAT_TOL = 2, 4, 16, 8, 1e-4
KERNEL_NAMES = ("k1", "k2", "k3", "k4", "k5", "k6a", "k6b", "k7a", "k7b")
# one H100 SXM: dense bf16 tensor-core rate and HBM3 rate (NVIDIA's data
# sheet); a bound is the larger of operations and bytes over these
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


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


def host_ms(fn, torch, calls=100):
    """Host time to issue one call: no synchronisation inside the loop, so
    the device's time is left out while the launch queue has room."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    issue = (time.perf_counter() - t) * 1e3 / calls
    torch.cuda.synchronize()
    return issue


def device_ms(fn, torch, kernels, reps=20, tries=4):
    """(mean device time of one call, {kernel name: its share}): the
    kernels' own time, summed by torch.profiler over `reps` calls, so the
    host's issue time (which the CUDA events of `time_ms` include when the
    host falls behind) is left out.  `fn` launches each kernel named in
    `kernels` once and no other; a trace that does not hold exactly that
    (the profiler drops events now and then) is taken again, and after
    `tries` such traces the time is None: a partial trace would undercount
    it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    fn()
    torch.cuda.synchronize()
    want = {k_: reps for k_ in kernels}
    for _ in range(tries):
        with prof(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name, counts = {}, {}
        for e in p.key_averages():
            if e.device_type == DeviceType.CUDA:
                found = re.search(r"\w+_kernel", e.key)
                name = found.group(0) if found else e.key[:40]
                by_name[name] = (by_name.get(name, 0.0)
                                 + e.self_device_time_total / 1e3 / reps)
                counts[name] = counts.get(name, 0) + e.count
        if counts == want:
            return sum(by_name.values()), by_name
        log(f"device_ms: the trace holds launches {counts}, one call "
            f"launches {want} over {reps} calls; taken again")
    log(f"device_ms: {tries} traces lost kernels; no device time reported")
    return None, {}


def k2_kernels(k1, route, x, g, w):
    """The kernels one K2 call on `route` launches: the correlation, the
    sum of the tensor-core route's pixel splits where it splits, and the
    reduces of the partials."""
    if route == "simt":
        return ("corr_partial_kernel", "corr_reduce_kernel",
                "da_reduce_kernel")
    b, h, w_, ci = x.shape
    splits = k1.bwd_w_workspace("tc", b, h, w_, ci, g.shape[-1], w.shape[0],
                                x.device.index)[0]
    return ("corr_tc_kernel",) + (("dw_reduce_kernel",) if splits else ()) \
        + ("da_reduce_kernel",)


def ms_text(v):
    return "not measured" if v is None else f"{v:.4f}"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops, moved):
    """(ms, what bounds it): the least time an H100 takes for work of
    `flops` operations that must move `moved` bytes."""
    ops_ms, bytes_ms = flops / PEAK_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def attn_bound(products, bh, nq, nk, d, moved):
    """Bound of attention work of `products` (nq, nk, d) matrix products."""
    return bound(2.0 * products * bh * nq * nk * d, moved)


def sdpa_operands(torch, q, k_pre, v, bias, nullk, nullv, null_bias, heads):
    """K3's function as the operands of one scaled_dot_product_attention
    call: (b, H, n, d) views, the null token as key 0, [null_bias, bias] as
    a float mask broadcast over the queries (in q's dtype, as the call
    takes it); the call's scale is 1."""
    b, nq, hd = q.shape
    nk, d = k_pre.shape[1], hd // heads
    qh = q.view(b, nq, heads, d).transpose(1, 2)
    kh = k_pre.view(b, nk, heads, d).transpose(1, 2)
    vh = v.view(b, nk, heads, d).transpose(1, 2)
    mask = (bias[:, :, None, :] if bias is not None
            else torch.zeros(b, heads, 1, nk, device=q.device))
    if nullk is not None:
        kh = torch.cat((nullk[None, :, None].expand(b, heads, 1, d), kh), 2)
        vh = torch.cat((nullv[None, :, None].expand(b, heads, 1, d), vh), 2)
        mask = torch.cat((null_bias[None, :, None, None].expand(
            b, heads, 1, 1), mask), 3)
    return qh, kh, vh, mask.to(q.dtype).contiguous()


def sdpa_times(torch, qh, kh, vh, mask, g=None):
    """ms of one scaled_dot_product_attention call on these operands, and
    of its backward (to q, k, v and the mask, as K4 gives dbias) for a
    cotangent g; a call PyTorch refuses gives None and the reason."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    try:
        fwd = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask, scale=1.0),
                      torch)
        if g is None:
            return fwd, None, None
        ins = [t.detach().requires_grad_() for t in (qh, kh, vh, mask)]
        out = sdpa(*ins[:3], attn_mask=ins[3], scale=1.0)
        gh = g.view(out.shape[0], out.shape[2], out.shape[1],
                    out.shape[3]).transpose(1, 2)
        bwd = time_ms(lambda: torch.autograd.grad(out, ins, gh,
                                                  retain_graph=True), torch)
        del out, ins
        return fwd, bwd, None
    except RuntimeError as e:
        return None, None, f"{type(e).__name__}: {str(e)[:200]}"


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


def expected_step_launches(n_convs, n_g_attn, n_d_attn, accum=1, chunks=0,
                           remat=False, remat_stages=False):
    """Launches per step the training path implies.  d_step: G forward
    without gradient (K1 per conv, K3 per G attention), D's attention
    forward (K3) and backward (K4); with R1, K4 once more for the penalty's
    input gradient, and then either K5 in the double backward
    (reverse-over-reverse) or, forward-over-reverse, per D attention in
    the surrogate φ: K6a (its forward on split heads), K7a (its jvp), and
    in the backward K7b (through the tangent) and K6b (through the primal,
    which later layers' tangents read).  g_step: G forward and backward (K1
    forward and as dx, K2 per conv), G's and D's attention forward and
    backward.

    ``accum``: each microbatch launches the step's kernels.  ``chunks``:
    the R1 penalty over that many chunks: the d_step's own D call without
    R1, then per chunk D's attention forward (K3), the input gradient (K4)
    and, in the chunk's backward, K5 and K4.  Recomputation adds D
    attention forwards (K3): ``remat`` reruns the microbatch's loss in each
    backward that reaches it (the R1 step's inner input gradient reaches
    it too, and the rerun takes that gradient again: one more K4; the
    g_step reruns G's forward too: one more K1 and G K3), ``remat_stages``
    reruns each D stage core in each backward through it (two with R1:
    the input gradient and the step's backward, and one more in each rerun
    of the loss that takes the input gradient).  Forward-over-reverse is
    counted without recomputation."""
    r, s = int(remat), int(remat_stages)
    none = dict(k5=0, k6a=0, k6b=0, k7a=0, k7b=0)
    d = dict(none, k1=n_convs, k2=0, k3=n_g_attn + (1 + r + s) * n_d_attn,
             k4=n_d_attn)
    if chunks:
        d_r1 = dict(d, k3=d["k3"] + chunks * (1 + 2 * s) * n_d_attn,
                    k4=(1 + 2 * chunks) * n_d_attn, k5=chunks * n_d_attn)
    else:
        d_r1 = dict(d, k3=n_g_attn + (1 + 2 * r + 2 * s + r * s) * n_d_attn,
                    k4=(2 + r) * n_d_attn, k5=n_d_attn)
    d_for = dict(d, k4=2 * n_d_attn, k6a=n_d_attn, k6b=n_d_attn,
                 k7a=n_d_attn, k7b=n_d_attn)
    g = dict(none, k1=(2 + r) * n_convs, k2=n_convs,
             k3=(1 + r) * n_g_attn + (1 + r + s) * n_d_attn,
             k4=n_g_attn + n_d_attn)
    return tuple({k: v * accum for k, v in row.items()}
                 for row in (d, d_r1, d_for, g))


def expected_t2i_launches(n_g, n_ga, n_da, n_p, n_v, accum=1):
    """Launches per step the text-conditioned path implies, for n_g 3x3
    adaptive convs in G, n_ga and n_da self-attentions in G and D, n_p
    adaptive convs in D's predictors and n_v in the vision-aided D (one per
    tap).  Every adaptive conv in a differentiated graph launches K1 as its
    dx (its input is modulated by a trained projection) and K2 (the
    Function's ``needs_input_grad`` is fixed when its forward runs, so K2
    runs even where only the input gradient is asked for: in R1's first
    backward, the VD penalty's, and for D's and the VD's convs in the
    g_step).

    d_step: G forward (K1 n_g, K3 n_ga); one D call whose rows include the
    matching-aware pairs (K1 n_p, K3 n_da) and its backward (K1 + K2 per
    predictor conv, K4 n_da); the VD on the real and the fake taps, and
    their backward.  With R1 reverse-over-reverse: the matching rows take
    a D call of their own, without multiscale outputs (K3 n_da, K4 n_da);
    the penalty's first backward (K1 + K2 per predictor conv, K4 n_da),
    whose nodes the step's backward runs again (K1 + K2 each, K5 n_da);
    the VD penalty alike over the real taps' convs.  Forward-over-reverse:
    the first backward without a graph, φ's convs on the unfused path (no
    K1/K2), K6a, K7a, K7b, K6b per D attention.  g_step: G forward and
    backward (K1 2·n_g, K2 n_g), D's and the VD's forward and backward to
    G; with accumulation the contrastive pool's pass runs G's forward once
    more per microbatch."""
    none = dict(k5=0, k6a=0, k6b=0, k7a=0, k7b=0)
    d = dict(none, k1=n_g + 2 * n_p + 4 * n_v, k2=n_p + 2 * n_v,
             k3=n_ga + n_da, k4=n_da)
    d_r1 = dict(d, k1=n_g + 4 * n_p + 6 * n_v, k2=3 * n_p + 4 * n_v,
                k3=n_ga + 2 * n_da, k4=3 * n_da, k5=n_da)
    d_for = dict(d, k1=n_g + 3 * n_p + 6 * n_v, k2=2 * n_p + 4 * n_v,
                 k3=n_ga + 2 * n_da, k4=3 * n_da, k6a=n_da, k6b=n_da,
                 k7a=n_da, k7b=n_da)
    pool = int(accum > 1)
    g = dict(none, k1=(2 + pool) * n_g + 2 * n_p + 2 * n_v,
             k2=n_g + n_p + n_v, k3=(1 + pool) * n_ga + n_da,
             k4=n_ga + n_da)
    return tuple({k: v * accum for k, v in row.items()}
                 for row in (d, d_r1, d_for, g))


def upsampler_structure(cfg):
    """(3x3 adaptive convs, full-attention layers) of a UnetUpsampler
    config's image forward: two convs in each ResnetBlock (two per down
    and per up stage, two in the middle, one at the end), the full
    attention of the down and up stages marked in ``full_attn`` and the
    middle's."""
    mults = cfg.get("dim_mults", (1, 2, 4, 8, 16))
    full = cfg.get("full_attn", (False, False, False, True, True))
    depths = cfg.get("attn_depths", (1,) * len(mults))
    n_attn = 2 * sum(d_ for f_, d_ in zip(full, depths) if f_) \
        + cfg.get("mid_attn_depth", 1)
    return 2 * (4 * len(mults) + 3), n_attn


def expected_upsampler_launches(cfg, n_d_attn):
    """Launches per step of the upsampler's training path: the
    quickstart's structure (``expected_step_launches``) for the adaptive
    convs and full attentions ``upsampler_structure`` counts in G (K1 per
    conv in the d_step's no-grad forward; forward, dx and K2 in the
    g_step; K3/K4 per attention, no null token) and D's ``n_d_attn``."""
    n_convs, n_g_attn = upsampler_structure(cfg)
    return expected_step_launches(n_convs, n_g_attn, n_d_attn)


def hv_operands(torch, gen, b, h, nq, nk, d, l2, masked, dtype, dev):
    """Prepared operands of K6a-K7b as the surrogate φ gives them:
    (q, k̂, v, bias), their tangents (tq, t̂k, tv, tbias), and the
    cotangents g (of out) and gt (of tout).  On φ's path k = q with the
    null token first, and the null token has no tangent."""
    from gigagan_tpu_torch.ops.kernels import flash_attention as k6
    from gigagan_tpu_torch.ops.kernels import flash_attention_hv as k7

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    q, tq = rnd(b, h, nq, d), rnd(b, h, nq, d)
    if not masked:  # shared q/k, the null token as key 0
        k = torch.cat((rnd(b, h, 1, d), q), 2)
        tk = torch.cat((torch.zeros(b, h, 1, d, device=dev), tq), 2)
        v = rnd(b, h, nk, d)
        tv = torch.cat((torch.zeros(b, h, 1, d, device=dev),
                        rnd(b, h, nk - 1, d)), 2)
        mask = None
    else:
        k, v, tk, tv = (rnd(b, h, nk, d) for _ in range(4))
        mask = torch.rand(b, nk, device=dev, generator=gen) > 0.3
        mask[:, 0] = True
        if masked == "all":  # sample 0: every key masked
            mask[0] = False
    q, k, v, tq, tk, tv = (x.to(dtype) for x in (q, k, v, tq, tk, tv))
    scale = d ** -0.5
    prepped = k6.prep_split(q, k, v, mask, l2, scale)
    tq_, tk_pre, tbias = k7.prep_tangents(q, k, tq, tk, mask, l2, scale)
    tvf = tv.reshape(b * h, nk, d).contiguous()
    g, gt = (rnd(b * h, nq, d).to(dtype) for _ in range(2))
    return prepped, (tq_, tk_pre, tvf, tbias), g, gt


def deterministic_resume():
    """Phase 12(d)'s resume under ``torch.use_deterministic_algorithms``,
    run as a child process (``--deterministic-resume``) whose parent set
    ``CUBLAS_WORKSPACE_CONFIG`` before CUDA started: the quickstart pair
    takes 2 iterations (R1 on the second), is saved and loaded into two
    fresh trainers, and all three take one more iteration with R1; their
    parameters and optimizer states must be bitwise equal.  Then two fresh
    upsampler trainers of the recipe take a d_step with R1 and a g_step
    from one seed (bitwise equal), and a small video upsampler's forward
    and backward run once (what the mode refuses there is reported).
    Prints one ``DETERMINISTIC {json}`` line; exits 1 when something
    differs or is refused."""
    import numpy as np
    import torch

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(REPO))
    from gigagan_tpu_torch import GigaGAN
    from gigagan_tpu_torch.data import MockImageDataset
    from gigagan_tpu_torch.models.layers import init_parameters
    from gigagan_tpu_torch.models.unet_upsampler import UnetUpsampler

    dev = torch.device("cuda", 0)
    out = dict(refused=None)
    models_dir = REPO / "gigagan-models" / "chip_smoke_deterministic"

    def pool_of(size, n):
        data = MockImageDataset(size, length=n, seed=0)
        return torch.from_numpy(np.stack([data[i] for i in range(n)])).to(
            dev)

    def same_state(a, b):
        """Names of the parameters, buffers and optimizer state entries in
        which two trainers differ."""
        diff = []
        for mod in ("G", "G_ema", "D"):
            for (n_, x), y in zip(getattr(a, mod).state_dict().items(),
                                  getattr(b, mod).state_dict().values()):
                if not torch.equal(x, y):
                    diff.append(f"{mod}.{n_}")
        for opt in ("g_opt", "d_opt"):
            sa, sb = (getattr(t_, opt).state_dict()["state"] for t_ in (a, b))
            for i, st in sa.items():
                for k, v in st.items():
                    if torch.is_tensor(v) and not torch.equal(v, sb[i][k]):
                        diff.append(f"{opt}.{i}.{k}")
        return diff

    try:
        pool = pool_of(256, BATCH)
        gan = GigaGAN(generator=QUICKSTART, discriminator=QUICKSTART_D,
                      amp=True, seed=0, device="cuda",
                      model_folder=str(models_dir))
        for i in range(2):
            gan.train_discriminator_step(pool, apply_gradient_penalty=i == 1,
                                         calc_multiscale_loss=True)
            gan.train_generator_step(BATCH, calc_multiscale_loss=True)
        ckpt = models_dir / "resume.ckpt"
        gan.save(ckpt)
        copies = []
        for _ in range(2):
            other = GigaGAN(generator=QUICKSTART, discriminator=QUICKSTART_D,
                            amp=True, seed=1, device="cuda")
            other.load(ckpt, strict=True)
            copies.append(other)
        for trainer in (gan, *copies):
            trainer.train_discriminator_step(
                pool, apply_gradient_penalty=True, calc_multiscale_loss=True)
            trainer.train_generator_step(BATCH, calc_multiscale_loss=True)
        torch.cuda.synchronize()
        out["resume_differs"] = {
            "continued_vs_resumed": same_state(gan, copies[0]),
            "resumed_vs_resumed": same_state(copies[0], copies[1])}
        n_state = sum(len(getattr(gan, m_).state_dict())
                      for m_ in ("G", "G_ema", "D"))
        out["resume_compared"] = n_state
        del gan, copies, other
        torch.cuda.empty_cache()

        up_pool = pool_of(UPSAMPLER_G["image_size"], 2)
        ups = []
        for _ in range(2):
            up = GigaGAN(generator=UPSAMPLER_G, discriminator=UPSAMPLER_D,
                         train_upsampler=True, amp=True, seed=0,
                         device="cuda")
            up.train_discriminator_step(up_pool, apply_gradient_penalty=True,
                                        calc_multiscale_loss=True, seed=1)
            up.train_generator_step(up_pool, calc_multiscale_loss=True,
                                    seed=2)
            ups.append(up)
        torch.cuda.synchronize()
        out["upsampler_differs"] = same_state(*ups)
        del ups, up
        torch.cuda.empty_cache()
    except Exception as e:  # noqa: BLE001 (reported in the JSON line)
        out["refused"] = f"{type(e).__name__}: {str(e)[:400]}"
        out["traceback"] = traceback.format_exc()[-2000:]
    finally:
        shutil.rmtree(models_dir, ignore_errors=True)

    # the video net's HF shuttle pools time with F.max_pool3d; its backward
    # is not on a train step (the trainer trains on images)
    try:
        small = dict(dim=16, image_size=32, input_image_size=8,
                     dim_mults=(1, 2, 4), full_attn=(False, False, True),
                     cross_attn=(False,) * 3, attn_depths=(1,) * 3,
                     temporal_attn_depths=(1,) * 3, has_temporal_layers=True,
                     style_network=dict(dim=16, depth=1))
        vid = UnetUpsampler(**small)
        init_parameters(vid, torch.Generator().manual_seed(0))
        vid.to(dev)
        clip = torch.rand(1, 4, 8, 8, 3, device=dev)
        vid(clip, noise=torch.randn(1, 16, device=dev)).sum().backward()
        torch.cuda.synchronize()
        out["video_backward"] = "ran"
    except Exception as e:  # noqa: BLE001 (reported in the JSON line)
        out["video_backward"] = f"{type(e).__name__}: {str(e)[:300]}"
    ok = out["refused"] is None and not any(
        out["resume_differs"].values()) and not out["upsampler_differs"]
    out["ok"] = ok
    print("DETERMINISTIC " + json.dumps(out), flush=True)
    return 0 if ok else 1


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
    from gigagan_tpu_torch import GigaGAN, OpenClipAdapter, ops
    from gigagan_tpu_torch.data import (
        MockImageDataset,
        MockTextImageDataset,
        SyntheticShapesDataset,
        cycle,
    )
    from gigagan_tpu_torch.train.steps import StepDraws
    from gigagan_tpu_torch.models.layers import AdaptiveConv, SelfAttention
    from gigagan_tpu_torch.ops import attention as ops_attention
    from gigagan_tpu_torch.ops.kernels import build, plain_reference
    from gigagan_tpu_torch.ops.kernels import adaptive_conv as k1
    from gigagan_tpu_torch.ops.kernels import flash_attention as k6
    from gigagan_tpu_torch.ops.kernels import flash_attention_fused as k3
    from gigagan_tpu_torch.ops.kernels import flash_attention_hv as k7
    from gigagan_tpu_torch.ops.kernels import flash_attention_so as so

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
    bf16 = torch.bfloat16
    OUT_DIR.mkdir(exist_ok=True)

    # every kernel counts the launches of both implementations; the
    # CUDA-core ones alone are read as well, to show that no bf16 call
    # reached them
    simt = {"k1": k1.adaptive_conv_fwd_simt,
            "k2": k1.adaptive_conv_bwd_w_simt,
            "k3": k3.flash_attention_fused_fwd_simt,
            "k4": so.flash_attention_fused_bwd_simt,
            "k5": so.flash_attention_so_bwd2_simt,
            "k6a": k6.flash_attention_fwd_simt,
            "k6b": k6.flash_attention_bwd_simt,
            "k7a": k7.flash_attention_hv_jvp_simt,
            "k7b": k7.flash_attention_hv_bwd_simt}
    tc_entry = {"k1": k1.adaptive_conv_fwd_tc,
                "k2": k1.adaptive_conv_bwd_w_tc,
                "k3": k3.flash_attention_fused_fwd_tc,
                "k4": so.flash_attention_fused_bwd_tc,
                "k5": so.flash_attention_so_bwd2_tc,
                "k6a": k6.flash_attention_fwd_tc,
                "k6b": k6.flash_attention_bwd_tc,
                "k7a": k7.flash_attention_hv_jvp_tc,
                "k7b": k7.flash_attention_hv_bwd_tc}
    counters = {k_: [tc_entry[k_], simt[k_]] for k_ in tc_entry}

    def reset_counts():
        for fns in counters.values():
            for fn in fns:
                fn.launches = 0

    def read_counts():
        return {k: sum(fn.launches for fn in fns)
                for k, fns in counters.items()}

    def simt_counts():
        return {k: fn.launches for k, fn in simt.items()}

    # where each kernel's tensor-core entry lives as a module attribute that
    # its dispatcher reads
    tc_home = {"k1": (k1, "adaptive_conv_fwd"),
               "k2": (k1, "adaptive_conv_bwd_w"),
               "k3": (k3, "flash_attention_fused_fwd"),
               "k4": (so, "flash_attention_fused_bwd"),
               "k5": (so, "flash_attention_so_bwd2"),
               "k6a": (k6, "flash_attention_fwd"),
               "k6b": (k6, "flash_attention_bwd"),
               "k7a": (k7, "flash_attention_hv_jvp"),
               "k7b": (k7, "flash_attention_hv_bwd")}

    @contextlib.contextmanager
    def simt_kernels(keys):
        """The kernels `keys` on their CUDA-core implementations for every
        dtype: the dispatch patched here, not through a switch of the
        package."""
        for k_ in keys:
            mod, base = tc_home[k_]
            setattr(mod, f"{base}_tc", simt[k_])
        try:
            yield
        finally:
            for k_ in keys:
                mod, base = tc_home[k_]
                setattr(mod, f"{base}_tc", tc_entry[k_])

    def launched_on(kname, call):
        """call() and the route of the kernel it launched on (None if it
        did not launch exactly once, on one route)."""
        before = {r: e[kname].launches for r, e in (("tc", tc_entry),
                                                      ("simt", simt))}
        res = call()
        ran = {r: e[kname].launches - before[r]
               for r, e in (("tc", tc_entry), ("simt", simt))}
        hit = [r for r, n_ in ran.items() if n_]
        return res, (hit[0] if len(hit) == 1 and ran[hit[0]] == 1
                     else None)

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    built = build.build_all(verbose=True)
    log(f"build: {len(built)} kernels in {time.perf_counter() - t0:.2f} s "
        "(one nvcc each, in parallel)")
    ptxas = []
    for kname, (path, text, secs) in built.items():
        log(f"  {kname}: {secs:.2f} s -> {path.relative_to(REPO)}")
        ptxas.append(f"== {kname}\n{text}")
        build.load(kname)
    (OUT_DIR / "ptxas.log").write_text("\n".join(ptxas))
    for kname, (_, text, _) in built.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        log(f"  ptxas {kname}: {len(regs)} kernels, at most {max(regs)} "
            f"registers and {max(spills, default=0)} bytes of spill stores "
            "(details in chiprun_out/ptxas.log)")
    # a tensor-core kernel that quietly lost its tensor cores or its TMA
    # loads fails here
    cuobjdump = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    report["sass"] = {}
    for kname in ("adaptive_conv_fwd_tc", "adaptive_conv_bwd_w_tc",
                  "flash_attention_fused_fwd_tc",
                  "flash_attention_fused_bwd_tc",
                  "flash_attention_so_bwd2_tc", "flash_attention_hv_jvp_tc",
                  "flash_attention_hv_bwd_tc"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(built[kname][0])],
                              capture_output=True, text=True,
                              check=True).stdout
        found = {op: len(re.findall(rf"\b{op}\b", sass))
                 for op in ("HGMMA", "UTMALDG")}
        report["sass"][kname] = found
        log(f"  sass {kname}: {found}")
        if not all(found.values()):
            fail(f"{kname} lacks tensor-core products or TMA loads: {found}")

    # ---------------------------------------------------------------- 3
    gen = torch.Generator(device=dev).manual_seed(0)
    convs = path_convs(QUICKSTART)

    def conv_operands(b, h, w_, ci, co, n):
        """x_mod, banks, selection weights and demod as the generator's
        AdaptiveConv hands them to K1."""
        x = torch.randn(b, h, w_, ci, device=dev, generator=gen)
        w = torch.randn(n, 3, 3, ci, co, device=dev, generator=gen) * (
            2.0 / (9 * ci)) ** 0.5
        a = torch.softmax(torch.randn(b, n, device=dev, generator=gen), -1)
        scale_in = 1.0 + 0.2 * torch.randn(b, ci, device=dev, generator=gen)
        d = ops.demod_scale(w, scale_in, a)
        return x * scale_in[:, None, None, :], w, a, d

    k1_rows = {}
    for _, h, ci, co in convs:
        if (h, ci, co) in k1_rows:
            continue
        xm, w, a, d = conv_operands(BATCH, h, h, ci, co, 2)
        want = k1.adaptive_conv_fwd_plain(xm, w, a, d)
        got32 = k1.adaptive_conv_fwd(xm, w, a, d)
        xb, wb = xm.bfloat16(), w.bfloat16()
        got16 = k1.adaptive_conv_fwd(xb, w, a, d)
        got16w = k1.adaptive_conv_fwd(xb, wb, a, d)
        torch.cuda.synchronize()
        # the yardstick: cuDNN's grouped conv (one group per sample) on the
        # pre-mixed, demodulated weights, mixed outside the timed call
        wg = torch.einsum("bn,nijcd,bd->bdcij", a, w, d).reshape(
            BATCH * co, ci, 3, 3).bfloat16()
        xg = xb.permute(0, 3, 1, 2).reshape(1, BATCH * ci, h, h)
        row = dict(
            h=h, ci=ci, co=co,
            route_bf16="tc" if k1.conv_uses_tensor_cores(bf16, ci, co)
            else "simt",
            rel_f32=rel_err(got32, want), rel_bf16=rel_err(got16, want),
            rel_bf16_banks=rel_err(got16w, want),
            abs_f32=abs_err(got32, want),
            abs_bf16=max(abs_err(got16, want), abs_err(got16w, want)),
            ms_f32=time_ms(lambda: k1.adaptive_conv_fwd(xm, w, a, d), torch),
            plain_ms_f32=time_ms(
                lambda: k1.adaptive_conv_fwd_plain(xm, w, a, d), torch),
            ms_bf16=time_ms(lambda: k1.adaptive_conv_fwd(xb, w, a, d),
                            torch),
            simt_ms_bf16=time_ms(
                lambda: k1.adaptive_conv_fwd_simt(xb, w, a, d), torch),
            plain_ms_bf16=time_ms(
                lambda: k1.adaptive_conv_fwd_plain(xb, w, a, d), torch),
            library_ms_bf16=time_ms(
                lambda: torch.nn.functional.conv2d(xg, wg, padding=1,
                                                   groups=BATCH), torch),
        )
        row["bound_ms"], row["bound_by"] = bound(
            2.0 * BATCH * h * h * 9 * ci * co,
            nbytes(xb, w, a, d) + nbytes(got16))
        k1_rows[(h, ci, co)] = row
        log(f"K1 b{BATCH} {h}x{h} {ci}->{co}: rel f32 {row['rel_f32']:.2e} "
            f"bf16 ({row['route_bf16']}) {row['rel_bf16']:.2e}, bf16 banks "
            f"{row['rel_bf16_banks']:.2e} | ms f32 {row['ms_f32']:.4f} "
            f"(plain {row['plain_ms_f32']:.4f}) bf16 {row['ms_bf16']:.4f} "
            f"(simt {row['simt_ms_bf16']:.4f}, plain "
            f"{row['plain_ms_bf16']:.4f}, cuDNN grouped conv "
            f"{row['library_ms_bf16']:.4f}, bound {row['bound_ms']:.4f})")
        if not (row["rel_f32"] <= K1_TOL_F32
                and max(row["rel_bf16"], row["rel_bf16_banks"])
                <= K1_TOL_BF16):
            fail(f"K1 disagrees at {row}")
    if any(r["route_bf16"] != "tc" for r in k1_rows.values()):
        fail("a path conv shape is not on the tensor-core K1")
    report["k1"] = list(k1_rows.values())
    # extra rows: a ragged map with co not a multiple of 32 (16-wide co
    # tiles), one bank, and the four banks of the conv pair's double
    # backward; bf16 with fp32 and bf16 banks on the tensor cores
    k1_extra = []
    for b, h, w_, ci, co, n in K1_EXTRA:
        xm, w, a, d = conv_operands(b, h, w_, ci, co, n)
        want = k1.adaptive_conv_fwd_plain(xm, w, a, d)
        xb = xm.bfloat16()
        before = tc_entry["k1"].launches
        got = [k1.adaptive_conv_fwd(xb, w, a, d),
               k1.adaptive_conv_fwd(xb, w.bfloat16(), a, d)]
        torch.cuda.synchronize()
        row = dict(b=b, h=h, w=w_, ci=ci, co=co, n=n,
                   rel=max(rel_err(g_, want) for g_ in got),
                   abs=max(abs_err(g_, want) for g_ in got),
                   tc=tc_entry["k1"].launches - before == 2)
        k1_extra.append(row)
        log(f"K1 extra b{b} {h}x{w_} {ci}->{co} n={n} bf16 (tc "
            f"{row['tc']}): rel {row['rel']:.2e}")
        if not (row["tc"] and row["rel"] <= K1_TOL_BF16):
            fail(f"K1 extra row failed: {row}")
    report["k1_extra"] = k1_extra

    # ---------------------------------------------------------------- 4

    def dtype_name(dtype):
        return str(dtype).split(".")[-1]

    def attn_operands(b, heads, nq, nk, d, l2, null, dtype):
        """K3's prepared operands from random q, k, v and null_kv."""
        q = torch.randn(b, nq, heads * d, device=dev, generator=gen).to(dtype)
        k, v = (torch.randn(b, nk, heads * d, device=dev,
                            generator=gen).to(dtype) for _ in range(2))
        null_kv = (torch.randn(2, heads, d, device=dev, generator=gen)
                   if null else None)
        k_pre, bias, nullk, nullv, null_bias = k3.prep_fused(
            k, v, null_kv, heads, l2, d ** -0.5)
        return q, k_pre, v, bias, nullk, nullv, null_bias, heads

    def attn_rows(timed_shapes):
        """(who, b, heads, nq, nk, d, l2, null, dtype, timed) of the
        attention phases: the path shapes (timed), then the small rows."""
        for who, b, n, l2 in timed_shapes:
            for dtype in (torch.float32, bf16):
                yield who, b, HEADS, n, n, DIM_HEAD, l2, True, dtype, True
        for who, b, h, nq, nk, d in ATTN_SMALL:
            for null in (True, False):
                for l2 in (False, True):
                    for dtype in (torch.float32, bf16):
                        yield who, b, h, nq, nk, d, l2, null, dtype, False

    k3_rows = []
    for who, b, h, nq, nk, d, l2, null, dtype, timed in attn_rows(ATTN_PATH):
        args = attn_operands(b, h, nq, nk, d, l2, null, dtype)
        o_want, l_want = k3.flash_attention_fused_fwd_plain(*args)
        o_got, l_got = k3.flash_attention_fused_fwd(*args)
        torch.cuda.synchronize()
        row = dict(
            who=who, b=b, heads=h, nq=nq, nk=nk, d=d, l2=l2, null=null,
            dtype=dtype_name(dtype),
            route="tc" if k3.uses_tensor_cores(dtype, d) else "simt",
            rel_out=rel_err(o_got, o_want), rel_lse=rel_err(l_got, l_want),
            abs_out=abs_err(o_got, o_want), abs_lse=abs_err(l_got, l_want))
        if timed:
            row["ms"] = time_ms(lambda: k3.flash_attention_fused_fwd(*args),
                                torch)
            row["plain_ms"] = time_ms(
                lambda: k3.flash_attention_fused_fwd_plain(*args), torch)
        if timed and dtype == bf16:
            row["simt_ms"] = time_ms(
                lambda: k3.flash_attention_fused_fwd_simt(*args), torch)
            row["library_ms"], _, row["library_note"] = sdpa_times(
                torch, *sdpa_operands(torch, *args))
            row["bound_ms"], row["bound_by"] = attn_bound(
                2, b * h, nq, nk + null, d,
                nbytes(*args[:-1], o_got, l_got))
        k3_rows.append(row)
        log(f"K3 {who} b{b} H{h} nq{nq} nk{nk} d{d} l2={l2} null={null} "
            f"{row['dtype']} ({row['route']}): rel out {row['rel_out']:.2e} "
            f"lse {row['rel_lse']:.2e}" + (
                f" | ms {row['ms']:.4f} (plain {row['plain_ms']:.4f}" + (
                    f", simt {row['simt_ms']:.4f}, SDPA {row['library_ms']}"
                    f", bound {row['bound_ms']:.4f}"
                    if "simt_ms" in row else "") + ")" if timed else ""))
        if not (row["rel_out"] <= K3_TOL and row["rel_lse"] <= K3_TOL):
            fail(f"K3 disagrees at {row}")
        del args, o_want, o_got, l_want, l_got
    torch.cuda.empty_cache()
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

    reset_counts()
    requests = [BATCH] * 3 + [1] * 3
    for i, bs in enumerate(requests):
        img = gan.generate(batch_size=bs, seed=i)
        size = QUICKSTART["image_size"]
        if img.shape != (bs, size, size, 3) or not np.isfinite(img).all():
            fail(f"request {i} gave {img.shape} / non-finite values")
    counts = read_counts()
    launches = {"k1": counts["k1"], "k3": counts["k3"]}
    for hk in hooks:
        hk.remove()
    log(f"sampling path: {len(requests)} requests, launches {counts}")
    per_forward = {"k1": len(convs), "k3": len(SELF_ATTN_RES)}
    if launches != {k: n * len(requests) for k, n in per_forward.items()}:
        fail(f"launch counts {launches}")
    if any(n for k, n in counts.items() if k not in ("k1", "k3")):
        fail(f"backward kernels launched while sampling: {counts}")
    if simt_counts()["k1"] or simt_counts()["k3"]:
        fail(f"bf16 sampling reached the CUDA-core K1/K3: {simt_counts()}")
    if seen != set(k1_rows):
        fail(f"path conv shapes {seen} != checked {set(k1_rows)}")
    report["sampling_launches"] = counts

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
        fail("G forward disagrees")

    def latency(bs, reps):
        """Seconds of `reps` requests on each K1 route: the package's
        (tensor cores) and the CUDA-core kernel patched in, taking turns so
        that the host's drift, which moves a request by more than K1 does,
        falls on both alike."""
        times = {"tc": [], "simt": []}
        for i in range(reps):
            for route in ("tc", "simt") if i % 2 else ("simt", "tc"):
                with (simt_kernels(["k1"]) if route == "simt"
                      else contextlib.nullcontext()):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    gan.generate(batch_size=bs, seed=100 + i)
                    torch.cuda.synchronize()
                times[route].append(time.perf_counter() - t)
        return times

    latency(1, 2)  # warm-up
    latency(BATCH, 2)
    lat1_all, lat8_all = latency(1, 25), latency(BATCH, 15)
    lat1, lat8 = (statistics.median(t["tc"]) for t in (lat1_all, lat8_all))
    report["latency_b1_s"], report["latency_b1_all_s"] = lat1, lat1_all["tc"]
    report["batch8_s"], report["batch8_all_s"] = lat8, lat8_all["tc"]
    report["latency_k1_simt"] = dict(b1_all_s=lat1_all["simt"],
                                     b8_all_s=lat8_all["simt"])
    report["batch8_images_per_s"] = BATCH / lat8
    log(f"generate latency b1: {lat1 * 1e3:.3f} ms (median of 25, min "
        f"{min(lat1_all['tc']) * 1e3:.3f}); b{BATCH}: {lat8 * 1e3:.3f} ms "
        f"(median of 15, min {min(lat8_all['tc']) * 1e3:.3f}) -> "
        f"{BATCH / lat8:.2f} images/s; in turn with K1 on the CUDA cores: "
        f"b1 {statistics.median(lat1_all['simt']) * 1e3:.3f} ms, "
        f"b{BATCH} {statistics.median(lat8_all['simt']) * 1e3:.3f} ms "
        f"[{smi}]")

    def profiled(label, fn):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        events = p.key_averages()
        table = events.table(sort_by="self_device_time_total", row_limit=40)
        (OUT_DIR / f"profile_{label}.txt").write_text(table)
        devev = [e for e in events if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in devev) / 1e3
        top = sorted(devev, key=lambda e: -e.self_device_time_total)[:10]
        report[f"profile_{label}"] = dict(
            wall_ms=wall_ms, device_busy_ms=busy_ms,
            device_kernels=sum(e.count for e in devev),
            top=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
                 for e in top])
        log(f"profile {label}: wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
            f"{sum(e.count for e in devev)} device kernels [{smi}]")
        for key, count, ms in report[f"profile_{label}"]["top"]:
            log(f"  {ms:9.3f} ms  x{count:<4d} {key}")

    if profile:
        for bs in (BATCH, 1):
            profiled(f"b{bs}", lambda: gan.generate(batch_size=bs, seed=1))
    del gan, gan32
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 6
    k2_rows = {}
    for _, h, ci, co in convs:
        if (h, ci, co) in k2_rows:
            continue
        x = torch.randn(BATCH, h, h, ci, device=dev, generator=gen)
        g = torch.randn(BATCH, h, h, co, device=dev, generator=gen)
        w = torch.randn(2, 3, 3, ci, co, device=dev, generator=gen) * (
            2.0 / (9 * ci)) ** 0.5
        a = torch.softmax(torch.randn(BATCH, 2, device=dev, generator=gen),
                          -1)
        d = 0.5 + torch.rand(BATCH, co, device=dev, generator=gen)
        xb, gb = x.bfloat16(), g.bfloat16()
        dw_want, da_want = k1.adaptive_conv_bwd_w_plain(x, g, w, a)
        # the plain version on the bf16 call's own inputs
        dw_same, da_same = k1.adaptive_conv_bwd_w_plain(xb, gb, w, a)
        (dw32, da32), route32 = launched_on(
            "k2", lambda: k1.adaptive_conv_bwd_w(x, g, w, a))
        (dw16, da16), route16 = launched_on(
            "k2", lambda: k1.adaptive_conv_bwd_w(xb, gb, w, a))
        if (route32, route16) != ("simt", "tc"):
            fail(f"K2 at {h}x{h} {ci}->{co} ran fp32 on {route32} and bf16 "
                 f"on {route16}, the rule names simt and tc")
        # K1 as dx through the conv Function's backward, against autograd
        # of the plain version
        xr = x.clone().requires_grad_()
        (dx_want,) = torch.autograd.grad(
            k1.adaptive_conv_fwd_plain(xr, w, a, d), xr, g)
        xk = x.clone().requires_grad_()
        (dx32,) = torch.autograd.grad(k1.pconv2d(xk, w, a, d), xk, g)
        xk16 = xb.clone().requires_grad_()
        before = tc_entry["k1"].launches
        (dx16,) = torch.autograd.grad(k1.pconv2d(xk16, w, a, d), xk16, gb)
        torch.cuda.synchronize()
        if tc_entry["k1"].launches - before != 2:
            fail(f"bf16 K1 forward and dx at {h}x{h} {ci}->{co} did not both "
                 "run on the tensor-core kernel")
        # the launch the backward makes, on its operands
        gs32 = g * d[:, None, None, :]
        gs16 = gs32.bfloat16()
        wft = k1.flip_t(w)
        ones = torch.ones(BATCH, ci, device=dev)
        row = dict(
            h=h, ci=ci, co=co,
            rel_dw_f32=rel_err(dw32, dw_want),
            rel_da_f32=rel_err(da32, da_want),
            rel_dw_bf16=rel_err(dw16, dw_want),
            rel_da_bf16=rel_err(da16, da_want),
            rel_dw_same=rel_err(dw16, dw_same),
            rel_da_same=rel_err(da16, da_same),
            rel_dx_f32=rel_err(dx32, dx_want),
            rel_dx_bf16=rel_err(dx16, dx_want),
            abs_f32=max(abs_err(dw32, dw_want), abs_err(da32, da_want)),
            abs_bf16=max(abs_err(dw16, dw_want), abs_err(da16, da_want)),
            abs_dx=max(abs_err(dx32, dx_want), abs_err(dx16, dx_want)),
            ms_f32=time_ms(lambda: k1.adaptive_conv_bwd_w(x, g, w, a),
                           torch),
            plain_ms_f32=time_ms(
                lambda: k1.adaptive_conv_bwd_w_plain(x, g, w, a), torch),
            ms_bf16=time_ms(lambda: k1.adaptive_conv_bwd_w(xb, gb, w, a),
                            torch),
            simt_ms_bf16=time_ms(
                lambda: k1.adaptive_conv_bwd_w_simt(xb, gb, w, a), torch),
            simt_device_ms_bf16=device_ms(
                lambda: k1.adaptive_conv_bwd_w_simt(xb, gb, w, a), torch,
                k2_kernels(k1, "simt", xb, gb, w))[0],
            plain_ms_bf16=time_ms(
                lambda: k1.adaptive_conv_bwd_w_plain(xb, gb, w, a), torch),
            dx_ms_bf16=time_ms(
                lambda: k1.adaptive_conv_fwd(gs16, wft, a, ones), torch),
            dx_simt_ms_bf16=time_ms(
                lambda: k1.adaptive_conv_fwd_simt(gs16, wft, a, ones),
                torch),
            dx_plain_ms_bf16=time_ms(
                lambda: k1.adaptive_conv_fwd_plain(gs16, wft, a, ones),
                torch),
        )
        row["device_ms_bf16"], row["device_kernels_bf16"] = device_ms(
            lambda: k1.adaptive_conv_bwd_w(xb, gb, w, a), torch,
            k2_kernels(k1, "tc", xb, gb, w))
        row["bound_ms"], row["bound_by"] = bound(
            2.0 * BATCH * h * h * 9 * ci * co,
            nbytes(xb, gb, w, a, dw16, da16))
        k2_rows[(h, ci, co)] = row
        log(f"K2 b{BATCH} {h}x{h} {ci}->{co}: rel dW/da f32 "
            f"{row['rel_dw_f32']:.2e}/{row['rel_da_f32']:.2e} bf16 "
            f"{row['rel_dw_bf16']:.2e}/{row['rel_da_bf16']:.2e} (same "
            f"inputs {row['rel_dw_same']:.2e}/{row['rel_da_same']:.2e}) | "
            f"ms f32 {row['ms_f32']:.4f} (plain {row['plain_ms_f32']:.4f}) "
            f"bf16 {row['ms_bf16']:.4f} (simt {row['simt_ms_bf16']:.4f}, "
            f"plain {row['plain_ms_bf16']:.4f}, bound {row['bound_ms']:.4f} "
            f"{row['bound_by']}; device time tc "
            f"{ms_text(row['device_ms_bf16'])} simt "
            f"{ms_text(row['simt_device_ms_bf16'])}; tc kernels "
            + ", ".join(f"{k_} {v:.4f}"
                        for k_, v in row["device_kernels_bf16"].items())
            + ") | "
            f"K1-dx rel f32 {row['rel_dx_f32']:.2e} bf16 "
            f"{row['rel_dx_bf16']:.2e} ms bf16 {row['dx_ms_bf16']:.4f} "
            f"(simt {row['dx_simt_ms_bf16']:.4f}, plain "
            f"{row['dx_plain_ms_bf16']:.4f})")
        if not (max(row["rel_dw_f32"], row["rel_da_f32"],
                    row["rel_dx_f32"]) <= K2_TOL_F32
                and max(row["rel_dw_bf16"], row["rel_da_bf16"],
                        row["rel_dx_bf16"]) <= K2_TOL_BF16
                and max(row["rel_dw_same"],
                        row["rel_da_same"]) <= K2_TOL_SAME):
            fail(f"K2 / K1-as-dx disagrees at {row}")
    report["k2"] = list(k2_rows.values())
    # extra rows for the tensor-core route's edges: fp32 on the CUDA cores,
    # bf16 (fp32 and bf16 banks) on the route the rule names, each call
    # one launch per group of that route's banks
    k2_extra = []
    for b, h, w_, ci, co, n in K2_EXTRA:
        x = torch.randn(b, h, w_, ci, device=dev, generator=gen)
        g = torch.randn(b, h, w_, co, device=dev, generator=gen)
        w = torch.randn(n, 3, 3, ci, co, device=dev, generator=gen) * (
            2.0 / (9 * ci)) ** 0.5
        a = torch.softmax(torch.randn(b, n, device=dev, generator=gen), -1)
        want = k1.adaptive_conv_bwd_w_plain(x, g, w, a)
        route = "tc" if k1.bwd_w_uses_tensor_cores(bf16, ci, co) else "simt"
        per_call = {"tc": -(-n // k1.MAX_BANKS_TC),
                    "simt": -(-n // k1.MAX_BANKS)}
        before = {r: e["k2"].launches for r, e in (("tc", tc_entry),
                                                    ("simt", simt))}
        xb, gb = x.bfloat16(), g.bfloat16()
        got32 = k1.adaptive_conv_bwd_w(x, g, w, a)
        got16 = [k1.adaptive_conv_bwd_w(xb, gb, wb, a)
                 for wb in (w, w.bfloat16())]
        torch.cuda.synchronize()
        same = [k1.adaptive_conv_bwd_w_plain(xb, gb, wb, a)
                for wb in (w, w.bfloat16())]
        ran = {r: e["k2"].launches - before[r] for r, e in (("tc", tc_entry),
                                                            ("simt", simt))}
        expect = {r: (per_call["simt"] if r == "simt" else 0)
                  + (2 * per_call[route] if r == route else 0)
                  for r in ("tc", "simt")}
        row = dict(b=b, h=h, w=w_, ci=ci, co=co, n=n, route_bf16=route,
                   launches=ran, launches_expected=expect,
                   rel_f32=max(rel_err(o, r_) for o, r_ in zip(got32, want)),
                   rel_bf16=max(rel_err(o, r_) for got in got16
                                for o, r_ in zip(got, want)),
                   rel_same=max(rel_err(o, r_) for got, ref in zip(got16, same)
                                for o, r_ in zip(got, ref)),
                   abs=max(abs_err(o, r_) for got in (got32, *got16)
                           for o, r_ in zip(got, want)))
        if route == "tc" and n <= k1.MAX_BANKS_TC:
            # each route's event time and host issue time per call
            for r, entry in (("tc", k1.adaptive_conv_bwd_w_tc),
                             ("simt", k1.adaptive_conv_bwd_w_simt)):
                row[f"{r}_ms"] = time_ms(lambda: entry(xb, gb, w, a), torch)
                row[f"{r}_host_ms"] = host_ms(lambda: entry(xb, gb, w, a),
                                              torch)
        k2_extra.append(row)
        log(f"K2 extra b{b} {h}x{w_} {ci}->{co} n={n}: rel f32 "
            f"{row['rel_f32']:.2e} bf16 ({route}) {row['rel_bf16']:.2e} "
            f"(same inputs {row['rel_same']:.2e}), launches {ran}"
            + (f", ms per call tc {row['tc_ms']:.4f} (host "
               f"{row['tc_host_ms']:.4f}) simt {row['simt_ms']:.4f} (host "
               f"{row['simt_host_ms']:.4f})" if "tc_ms" in row else ""))
        if not (ran == expect and row["rel_f32"] <= K2_TOL_F32
                and row["rel_bf16"] <= K2_TOL_BF16
                and row["rel_same"] <= K2_TOL_SAME):
            fail(f"K2 extra row failed: {row}")
    report["k2_extra"] = k2_extra
    # more banks than one K2 launch takes: the wrapper's groups of 4 (CUDA
    # cores) and 2 (tensor cores)
    b, h, ci, co, n = K2_BANKS
    x = torch.randn(b, h, h, ci, device=dev, generator=gen)
    g = torch.randn(b, h, h, co, device=dev, generator=gen)
    w = torch.randn(n, 3, 3, ci, co, device=dev, generator=gen) * (
        2.0 / (9 * ci)) ** 0.5
    a = torch.softmax(torch.randn(b, n, device=dev, generator=gen), -1)
    want = k1.adaptive_conv_bwd_w_plain(x, g, w, a)
    before = (simt["k2"].launches, tc_entry["k2"].launches)
    xb, gb = x.bfloat16(), g.bfloat16()
    got32 = k1.adaptive_conv_bwd_w(x, g, w, a)
    got16 = k1.adaptive_conv_bwd_w(xb, gb, w, a)
    torch.cuda.synchronize()
    same = k1.adaptive_conv_bwd_w_plain(xb, gb, w, a)
    row = dict(b=b, h=h, ci=ci, co=co, n=n,
               launches=(simt["k2"].launches - before[0],
                         tc_entry["k2"].launches - before[1]),
               rel_f32=max(rel_err(o, w_) for o, w_ in zip(got32, want)),
               rel_bf16=max(rel_err(o, w_) for o, w_ in zip(got16, want)),
               rel_same=max(rel_err(o, w_) for o, w_ in zip(got16, same)),
               abs=max(abs_err(o, w_) for o, w_ in zip((*got32, *got16),
                                                      want * 2)))
    report["k2_banks"] = row
    log(f"K2 b{b} {h}x{h} {ci}->{co} n={n}: (CUDA-core, tensor-core) "
        f"launches {row['launches']} for an fp32 and a bf16 call, rel f32 "
        f"{row['rel_f32']:.2e} bf16 {row['rel_bf16']:.2e} (same inputs "
        f"{row['rel_same']:.2e})")
    if not (row["launches"] == (-(-n // k1.MAX_BANKS),
                                -(-n // k1.MAX_BANKS_TC))
            and row["rel_f32"] <= K2_TOL_F32
            and row["rel_bf16"] <= K2_TOL_BF16
            and row["rel_same"] <= K2_TOL_SAME):
        fail(f"K2 at {n} banks failed: {row}")
    del x, g, w, a, want, got32, got16, same

    # ---------------------------------------------------------------- 7
    k4_rows, k5_rows = [], []
    for who, b, h, nq, nk, d, l2, null, dtype, timed in attn_rows(ATTN_PATH):
        args = attn_operands(b, h, nq, nk, d, l2, null, dtype)
        q, k_pre, v, bias, nullk, nullv, null_bias, _ = args
        g = torch.randn(q.shape, device=dev, generator=gen).to(dtype)
        out, lse = k3.flash_attention_fused_fwd(*args)
        bargs = (q, k_pre, v, bias, nullk, nullv, null_bias, g, out, lse, h)
        want = so.flash_attention_fused_bwd_plain(*bargs)
        got = so.flash_attention_fused_bwd(*bargs)
        torch.cuda.synchronize()
        pairs = [(a_, w_) for a_, w_ in zip(got, want) if w_ is not None]
        row = dict(
            who=who, b=b, heads=h, nq=nq, nk=nk, d=d, l2=l2, null=null,
            dtype=dtype_name(dtype),
            route="tc" if k3.uses_tensor_cores(dtype, d) else "simt",
            rel=max(rel_err(a_, w_) for a_, w_ in pairs),
            abs=max(abs_err(a_, w_) for a_, w_ in pairs))
        if timed:
            row["ms"] = time_ms(lambda: so.flash_attention_fused_bwd(*bargs),
                                torch)
            row["plain_ms"] = time_ms(
                lambda: so.flash_attention_fused_bwd_plain(*bargs), torch)
        if timed and dtype == bf16:
            row["simt_ms"] = time_ms(
                lambda: so.flash_attention_fused_bwd_simt(*bargs), torch)
            _, row["library_ms"], row["library_note"] = sdpa_times(
                torch, *sdpa_operands(torch, *args), g)
            row["bound_ms"], row["bound_by"] = attn_bound(
                5, b * h, nq, nk + null, d,
                nbytes(*bargs[:-1], *(t for t in got if t is not None)))
        k4_rows.append(row)
        log(f"K4 {who} b{b} H{h} nq{nq} nk{nk} d{d} l2={l2} null={null} "
            f"{row['dtype']} ({row['route']}): rel {row['rel']:.2e}" + (
                f" | ms {row['ms']:.4f} (plain {row['plain_ms']:.4f}" + (
                    f", simt {row['simt_ms']:.4f}, SDPA backward "
                    f"{row['library_ms']}, bound {row['bound_ms']:.4f}"
                    if "simt_ms" in row else "") + ")" if timed else ""))
        if not row["rel"] <= K4_TOL:
            fail(f"K4 disagrees at {row}")
        del got, pairs
        # K5 at the R1 shapes of the d_step (timed), at every ragged small
        # row (null or not, dot or L2) and at the wider heads' rows
        r1_row = (who, b, nq, l2) in R1_ATTN
        if not (r1_row or who == "ragged"
                or (null and who in ("d128", "d80"))):
            del args, bargs, want, out, lse, g
            torch.cuda.empty_cache()
            continue
        cots = [None if w_ is None else torch.randn(
            w_.shape, device=dev, generator=gen).to(w_.dtype) for w_ in want]
        args5 = (*bargs[:8], lse, *cots, h)
        want5 = so.flash_attention_so_bwd2_plain(*args5)
        got5 = so.flash_attention_so_bwd2(*args5)
        torch.cuda.synchronize()
        pairs = [(a_, w_) for a_, w_ in zip(got5, want5) if w_ is not None]
        row5 = dict(
            who=who, b=b, heads=h, nq=nq, nk=nk, d=d, l2=l2, null=null,
            dtype=dtype_name(dtype),
            route="tc" if so.so_uses_tensor_cores(dtype, d) else "simt",
            rel=max(rel_err(a_, w_) for a_, w_ in pairs),
            abs=max(abs_err(a_, w_) for a_, w_ in pairs))
        if r1_row:
            row5["ms"] = time_ms(lambda: so.flash_attention_so_bwd2(*args5),
                                 torch)
            row5["plain_ms"] = time_ms(
                lambda: so.flash_attention_so_bwd2_plain(*args5), torch)
            if dtype == bf16:
                row5["simt_ms"] = time_ms(
                    lambda: so.flash_attention_so_bwd2_simt(*args5), torch)
            # the products the adjoint needs: S, dA, two for c_dS, G·C̃ᵀ,
            # then two each for c_q, c_g, c_k and one for c_v
            row5["bound_ms"], row5["bound_by"] = attn_bound(
                12, b * h, nq, nk + 1, d,
                nbytes(*args5[:-1], *(t for t in got5 if t is not None)))
        k5_rows.append(row5)
        log(f"K5 {who} b{b} H{h} nq{nq} nk{nk} d{d} l2={l2} null={null} "
            f"{row5['dtype']} ({row5['route']}): rel {row5['rel']:.2e}" + (
                f" | ms {row5['ms']:.4f} (plain {row5['plain_ms']:.4f}, "
                + (f"simt {row5['simt_ms']:.4f}, " if "simt_ms" in row5
                   else "")
                + f"bound {row5['bound_ms']:.4f})" if r1_row else ""))
        if not row5["rel"] <= K5_TOL:
            fail(f"K5 disagrees at {row5}")
        del want5, got5, args5, cots, pairs, args, bargs, want, out, lse, g
        torch.cuda.empty_cache()
    report["k4"], report["k5"] = k4_rows, k5_rows

    # ---------------------------------------------------------------- 8
    def hv_route(kname, dtype, d):
        """The route the rule of K6a/K6b (K3/K4's) or K7a/K7b names."""
        rule = (k3.uses_tensor_cores if kname in ("k6a", "k6b")
                else k7.hv_uses_tensor_cores)
        return "tc" if rule(dtype, d) else "simt"

    hv_rows = []
    for who, b, h, nq, nk, d, l2, masked in HV_PATH:
        for dtype in (torch.float32, torch.bfloat16):
            tol = K67_TOL_F32 if dtype == torch.float32 else K67_TOL_BF16
            operands, tang, g, gt = hv_operands(
                torch, gen, b, h, nq, nk, d, l2, masked, dtype, dev)
            go = g if masked else None  # φ puts no cotangent on out
            out, lse = k6.flash_attention_fwd_plain(*operands)
            lse7 = k7.flash_attention_hv_jvp_plain(*operands, *tang)[2]
            checks = {
                "k6a": (lambda: k6.flash_attention_fwd(*operands),
                        lambda: k6.flash_attention_fwd_plain(*operands)),
                "k6b": (lambda: k6.flash_attention_bwd(*operands, g, out,
                                                       lse),
                        lambda: k6.flash_attention_bwd_plain(*operands, g,
                                                             out, lse)),
                "k7a": (lambda: k7.flash_attention_hv_jvp(*operands, *tang),
                        lambda: k7.flash_attention_hv_jvp_plain(*operands,
                                                                *tang)),
                "k7b": (lambda: k7.flash_attention_hv_bwd(
                            *operands, *tang, lse7, go, gt),
                        lambda: k7.flash_attention_hv_bwd_plain(
                            *operands, *tang, lse7, go, gt)),
            }
            simt_calls = {
                "k6a": lambda: k6.flash_attention_fwd_simt(*operands),
                "k6b": lambda: k6.flash_attention_bwd_simt(*operands, g,
                                                           out, lse),
                "k7a": lambda: k7.flash_attention_hv_jvp_simt(*operands,
                                                              *tang),
                "k7b": lambda: k7.flash_attention_hv_bwd_simt(
                    *operands, *tang, lse7, go, gt)}
            row = dict(who=who, bh=b * h, nq=nq, nk=nk, d=d, l2=l2,
                       masked=masked, dtype=str(dtype).split(".")[-1],
                       route_k6=hv_route("k6a", dtype, d),
                       route_k7=hv_route("k7a", dtype, d))
            phi_bf16 = who == "phi" and dtype == torch.bfloat16
            if phi_bf16:
                # products per call: K6a S, P·V; K6b S, dA, dq, dk, dv; K7a
                # S, two for T, P·V, P·tV, (P⊙T)·V; K7b (no cotangent on
                # out) S, two for T, two for the pieces, eight for the
                # cotangents of q, tq, k, tk, v, tv
                # (bytes: the outputs of K6b and K7b are the size of their
                # operands, each row's out the size of g, lse 4 b·h·nq)
                ob, tb, rb = nbytes(*operands), nbytes(*tang), nbytes(g)
                lb = 4 * b * h * nq
                for kname, products, moved in (
                        ("k6a", 2, ob + rb + lb),
                        ("k6b", 5, 2 * ob + 2 * rb + lb),
                        ("k7a", 6, ob + tb + 2 * rb + lb),
                        ("k7b", 13, 2 * (ob + tb) + rb + lb)):
                    row[kname + "_bound"] = attn_bound(products, b * h, nq,
                                                       nk, d, moved)
                qh, kh, vh = (t[:, None] for t in operands[:3])
                mask = operands[3][:, None, None, :].to(dtype)
                fwd_ms, bwd_ms, note = sdpa_times(torch, qh, kh, vh, mask, g)
                row["k6a_library"], row["k6b_library"] = fwd_ms, bwd_ms
                row["library_note"] = note
            for kname, (kernel, plain) in checks.items():
                got, route = launched_on(kname, kernel)
                named = row["route_" + kname[:2]]
                if route != named:
                    fail(f"{kname.upper()} at {row} ran on {route}, the "
                         f"rule names {named}")
                want = plain()
                torch.cuda.synchronize()
                pairs = list(zip(got, want))
                row[kname] = dict(
                    rel=max(rel_err(a_, w_) for a_, w_ in pairs),
                    abs=max(abs_err(a_, w_) for a_, w_ in pairs))
                del got, want, pairs
                torch.cuda.empty_cache()
                row[kname]["ms"] = time_ms(kernel, torch)
                row[kname]["plain_ms"] = time_ms(plain, torch)
                if phi_bf16:
                    row[kname]["simt_ms"] = time_ms(simt_calls[kname], torch)
                torch.cuda.empty_cache()
                if not row[kname]["rel"] <= tol:
                    fail(f"{kname.upper()} disagrees at {row}")
            hv_rows.append(row)
            log(f"K6a-K7b {who} bh{b * h} nq{nq} nk{nk} d{d} l2={l2} "
                f"{row['dtype']} (tol {tol}; K6 on {row['route_k6']}, K7 on "
                f"{row['route_k7']}): "
                + "; ".join(
                    f"{k_} rel {row[k_]['rel']:.2e} ms {row[k_]['ms']:.4f} "
                    + (f"(simt {row[k_]['simt_ms']:.4f}, " if "simt_ms"
                       in row[k_] else "(")
                    + f"plain {row[k_]['plain_ms']:.4f})" for k_ in checks)
                + (f"; SDPA {row['k6a_library']} / backward "
                   f"{row['k6b_library']}; bounds K6a-K7b "
                   + " / ".join(f"{row[k_ + '_bound'][0]:.4f}"
                                for k_ in checks) + f" [{smi}]" if phi_bf16
                   else ""))
            del operands, tang, g, gt, go, out, lse, lse7, checks, simt_calls
            torch.cuda.empty_cache()
    report["k6_k7"] = hv_rows

    # K6a-K7b where one sample has every key masked, on each route that
    # takes the dtype: finite, and the plain version's numbers (lse exactly
    # NEG_INF on the all-masked rows, from K6a and from K7a)
    def rel_abs(got, want):
        pairs = list(zip(got, want))
        return dict(rel=max(rel_err(a_, w_) for a_, w_ in pairs),
                    abs=max(abs_err(a_, w_) for a_, w_ in pairs))

    k6_masked = []
    who, b, h, nq, nk, d, l2, masked = K6_ALL_MASKED
    for dtype in (torch.float32, bf16):
        tol = K67_TOL_F32 if dtype == torch.float32 else K67_TOL_BF16
        operands, tang, g, gt = hv_operands(torch, gen, b, h, nq, nk, d,
                                            l2, masked, dtype, dev)
        dead = (operands[3] == k6.NEG_INF).all(-1)
        if not dead.any() or dead.all():
            fail(f"the all-masked K6 row has {int(dead.sum())} dead rows")
        out, lse = k6.flash_attention_fwd_plain(*operands)
        jvp = k7.flash_attention_hv_jvp_plain(*operands, *tang)
        kernels_ = (
            ("k6", k6, "flash_attention_fwd", "flash_attention_bwd", operands,
             (*operands, g, out, lse), (out, lse),
             k6.flash_attention_bwd_plain(*operands, g, out, lse)),
            ("k7", k7, "flash_attention_hv_jvp", "flash_attention_hv_bwd",
             (*operands, *tang), (*operands, *tang, jvp[2], g, gt), jvp,
             k7.flash_attention_hv_bwd_plain(*operands, *tang, jvp[2], g, gt)))
        for r in ("tc", "simt"):
            ran = [k_ for k_, *_ in kernels_
                   if r == "simt" or hv_route(k_ + "a", dtype, d) == "tc"]
            if not ran:
                continue
            row = dict(who=who, bh=b * h, nq=nq, nk=nk, d=d,
                       dtype=str(dtype).split(".")[-1], route=r,
                       dead_rows=int(dead.sum()), finite=True,
                       lse_dead_exact=True)
            for (k_, mod, fwd, bwd, fwd_args, bwd_args, want_f,
                 want_b) in kernels_:
                if k_ not in ran:
                    continue
                got_f = getattr(mod, f"{fwd}_{r}")(*fwd_args)
                got_b = getattr(mod, f"{bwd}_{r}")(*bwd_args)
                torch.cuda.synchronize()
                got_l, want_l = got_f[-1], want_f[-1]
                row["finite"] &= all(bool(torch.isfinite(x).all())
                                     for x in (*got_f, *got_b))
                row["lse_dead_exact"] &= bool(
                    (got_l[dead] == want_l[dead]).all())
                row[k_ + "a"] = rel_abs((*got_f[:-1], got_l[~dead]),
                                        (*want_f[:-1], want_l[~dead]))
                row[k_ + "b"] = rel_abs(got_b, want_b)
                del got_f, got_b
            k6_masked.append(row)
            names = [k_ + x for k_ in ran for x in "ab"]
            log(f"K6a-K7b {who} bh{b * h} nq{nq} nk{nk} d{d} {row['dtype']} "
                f"({r}, {row['dead_rows']} all-masked rows): finite "
                f"{row['finite']}, lse NEG_INF there {row['lse_dead_exact']},"
                + "".join(f" rel {n_.upper()} {row[n_]['rel']:.2e}"
                          for n_ in names) + f" (tol {tol})")
            if not (row["finite"] and row["lse_dead_exact"]
                    and max(row[n_]["rel"] for n_ in names) <= tol):
                fail(f"K6a-K7b with all-masked rows failed: {row}")
        del operands, tang, g, gt, out, lse, jvp, kernels_
        torch.cuda.empty_cache()
    report["k6_all_masked"] = k6_masked

    # ------------------------------------------------------------- 9, 10
    data = MockImageDataset(QUICKSTART["image_size"], length=8 * BATCH,
                            seed=0)
    batches = [torch.from_numpy(b_).to(dev)
               for b_ in data.get_dataloader(BATCH)]

    def drive_training(label, fwd_over_rev):
        """Warm-up, then ITERATIONS iterations with counted launches;
        returns (steps, launches over the run, timing, the gan)."""
        t0 = time.perf_counter()
        gan = GigaGAN(generator=QUICKSTART, discriminator=QUICKSTART_D,
                      amp=True, device="cuda", seed=0,
                      gp_fwd_over_rev=fwd_over_rev)
        n_g = sum(p.numel() for p in gan.G.parameters())
        n_d = sum(p.numel() for p in gan.D.parameters())
        log(f"G+D ({label}): {n_g / 1e6:.2f}M + {n_d / 1e6:.2f}M params, "
            f"built in {time.perf_counter() - t0:.2f} s")
        n_d_attn = sum(s.core.attn is not None for s in gan.D.stages)
        n_g_attn = sum(s.self_attn is not None for s in gan.G.stages)
        exp_d, exp_d_r1, exp_d_for, exp_g = expected_step_launches(
            len(convs), n_g_attn, n_d_attn)
        if fwd_over_rev:
            exp_d_r1 = exp_d_for

        def iteration(i, apply_gp, record=None):
            real = batches[i % len(batches)]
            steps = []
            for kind in ("d", "g"):
                before = read_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                if kind == "d":
                    m = gan.train_discriminator_step(
                        real, apply_gradient_penalty=apply_gp,
                        calc_multiscale_loss=True, seed=1000 + i)
                else:
                    m = gan.train_generator_step(
                        BATCH, calc_multiscale_loss=True, seed=2000 + i)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                after = read_counts()
                steps.append(dict(
                    kind=kind, r1=apply_gp, ms=ms,
                    losses={k: float(v) for k, v in m.items()},
                    launches={k: after[k] - before[k] for k in after}))
            if record is not None:
                record.extend(steps)
            return steps

        iteration(0, True)  # warm-up: allocator, cuDNN plans, both variants
        iteration(1, False)

        reset_counts()
        steps = []
        for i in range(ITERATIONS):
            iteration(i, i % R1_EVERY == 0, steps)
        launches = read_counts()
        if any(simt_counts().values()):
            fail(f"bf16 calls of the {label} path reached the CUDA-core "
                 f"kernels: {simt_counts()}")
        for s in steps:
            want = exp_g if s["kind"] == "g" else (exp_d_r1 if s["r1"]
                                                   else exp_d)
            log(f"train ({label}) {s['kind']}_step r1={s['r1']}: "
                f"{s['ms']:.3f} ms, launches {s['launches']}, losses "
                + ", ".join(f"{k} {v:.4g}" for k, v in s["losses"].items()))
            if not all(np.isfinite(v) for v in s["losses"].values()):
                fail(f"non-finite losses in {s}")
            if s["launches"] != want:
                fail(f"{s['kind']}_step (r1={s['r1']}, {label}) launched "
                     f"{s['launches']}, the path implies {want}")
        log(f"training path ({label}): {ITERATIONS} iterations, launches "
            f"{launches}")
        used = [k for k in KERNEL_NAMES
                if any(row[k] for row in (exp_d, exp_d_r1, exp_g))]
        if any(launches[k] == 0 for k in used):
            fail(f"a kernel of the {label} path was never launched: "
                 f"{launches}")

        d_plain = [s["ms"] for s in steps if s["kind"] == "d"
                   and not s["r1"]]
        d_r1 = [s["ms"] for s in steps if s["kind"] == "d" and s["r1"]]
        g_ms = [s["ms"] for s in steps if s["kind"] == "g"]
        cadence_ms = sum(s["ms"] for s in steps[2 * R1_EVERY:4 * R1_EVERY])
        timing = dict(
            d_step_ms=statistics.median(d_plain),
            d_step_r1_ms=statistics.median(d_r1),
            g_step_ms=statistics.median(g_ms),
            cadence_ms=cadence_ms,
            images_per_s=R1_EVERY * BATCH / (cadence_ms / 1e3),
        )
        log(f"train ({label}) b{BATCH} bf16: d_step "
            f"{timing['d_step_ms']:.3f} ms (median of {len(d_plain)}), "
            f"d_step+R1 {timing['d_step_r1_ms']:.3f} ms (median of "
            f"{len(d_r1)}), g_step {timing['g_step_ms']:.3f} ms (median of "
            f"{len(g_ms)}); iterations 4-7 (one R1) "
            f"{timing['cadence_ms']:.3f} ms -> "
            f"{timing['images_per_s']:.2f} images/s [{smi}]")
        if profile:
            suffix = "_for" if fwd_over_rev else ""
            if not fwd_over_rev:
                profiled("train_iter", lambda: iteration(1, False))
            profiled(f"train_iter_r1{suffix}", lambda: iteration(0, True))
        del gan
        torch.cuda.empty_cache()
        return steps, launches, timing

    steps, train_launches, timing = drive_training("reverse-over-reverse R1",
                                                   False)
    report["train_steps"], report["train_timing"] = steps, timing
    steps, for_launches, for_timing = drive_training(
        "forward-over-reverse R1", True)
    report["train_steps_fwd_over_rev"] = steps
    report["train_timing_fwd_over_rev"] = for_timing
    log(f"d_step+R1 b{BATCH} bf16: forward-over-reverse "
        f"{for_timing['d_step_r1_ms']:.3f} ms, reverse-over-reverse "
        f"{timing['d_step_r1_ms']:.3f} ms [{smi}]")
    del batches
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 11
    # fp32 steps through the kernels against the same steps on the plain
    # path, each from the same fresh state; then bf16 steps through the
    # tensor-core K3/K4, K1/K5, K2, K6a/K6b and K7a/K7b against the CUDA-core
    # ones, each route also held to its distance from the fp32 plain step
    real = torch.from_numpy(np.stack([data[i] for i in range(BATCH)])).to(dev)

    def fp32_step(kind, plain, fwd_over_rev=False, amp=False):
        g32 = GigaGAN(generator=QUICKSTART, discriminator=QUICKSTART_D,
                      amp=amp, device="cuda", seed=0,
                      gp_fwd_over_rev=fwd_over_rev)
        with (plain_reference() if plain else contextlib.nullcontext()):
            if kind == "d":
                m = g32.train_discriminator_step(
                    real, apply_gradient_penalty=True,
                    calc_multiscale_loss=True, seed=7)
                model = g32.D
            else:
                m = g32.train_generator_step(
                    BATCH, calc_multiscale_loss=True, seed=7)
                model = g32.G
        losses_ = {k: float(v) for k, v in m.items()}
        grads = {n_: p.grad.detach().clone()
                 for n_, p in model.named_parameters()}
        del g32, model
        torch.cuda.empty_cache()
        return losses_, grads

    def compare(label, got, want, loss_keys=None, tol=STEP_TOL_F32,
                stable=None):
        """Losses and every gradient leaf, max-rel, all held to `tol` (None:
        only reported) or, given `stable` (an fp32 comparison of the same
        step), the leaves ``informative`` names (moved by at most
        STABLE_F32 there, G's Noise weights and the style network's
        unresolved leaves excepted); the others are reported by name."""
        (l_got, g_got), (l_want, g_want) = got, want
        loss_keys = loss_keys or list(l_want)
        loss_rel = max(abs(l_got[k] - l_want[k]) / (abs(l_want[k]) + 1e-6)
                       for k in loss_keys)
        grad_rel = {n_: rel_err(g_got[n_], g_want[n_]) for n_ in g_want}
        gated = grad_rel
        if stable is not None:
            gated = {n_: r for n_, r in grad_rel.items()
                     if informative(n_, stable["grad_rel"][n_])}
            loose = {n_: (r, stable["grad_rel"][n_])
                     for n_, r in grad_rel.items() if n_ not in gated}
            log(f"{label}: {len(loose)} leaves not gated, moved by more than "
                f"{STABLE_F32} in fp32 or unresolved at bf16 (leaf: rel here, "
                "rel in fp32): "
                + ", ".join(f"{n_}: {a:.2e}, {b:.2e}"
                            for n_, (a, b) in loose.items()))
        worst = max(gated, key=gated.get)
        top = sorted(gated, key=gated.get)[-5:]
        log(f"{label}: largest gated leaves: "
            + ", ".join(f"{n_} {gated[n_]:.2e}" for n_ in reversed(top)))
        out = dict(losses_got=l_got, losses_want=l_want, loss_rel=loss_rel,
                   grad_rel_max=gated[worst], worst=worst, grad_rel=grad_rel)
        log(f"{label}: losses rel {loss_rel:.2e} "
            f"({', '.join(loss_keys)}), gradients max rel "
            f"{gated[worst]:.2e} ({worst}) over {len(gated)} leaves "
            + (f"(tol {tol})" if tol is not None else "(not gated)"))
        if tol is not None and not (loss_rel <= tol
                                    and gated[worst] <= tol):
            fail(f"{label} disagrees: {out}")
        return out

    plain_step = {kind: fp32_step(kind, True) for kind in ("d", "g")}
    plain_step["d_fwd_over_rev"] = fp32_step("d", True, True)
    d_ror, d_for = fp32_step("d", False), fp32_step("d", False, True)
    report["step_vs_plain_f32"] = step_rel = {}
    step_rel["d"] = compare("fp32 d_step +R1 kernels vs plain path", d_ror,
                            plain_step["d"])
    step_rel["d_fwd_over_rev"] = compare(
        "fp32 d_step +R1 forward-over-reverse, kernels vs plain path", d_for,
        plain_step["d_fwd_over_rev"])
    step_rel["d_fwd_over_rev_vs_ror"] = compare(
        "fp32 d_step +R1 forward-over-reverse vs reverse-over-reverse, "
        "kernels", d_for, d_ror, loss_keys=["gradient_penalty"])
    del d_ror, d_for
    step_rel["g"] = compare("fp32 g_step kernels vs plain path",
                            fp32_step("g", False), plain_step["g"])

    def bf16_step(kind, route, keys):
        """A bf16 step of `kind` ("d", "g", or "d_fwd_over_rev": the d_step
        with R1 taken forward-over-reverse) with the kernels `keys` on
        `route`."""
        reset_counts()
        with (simt_kernels(keys) if route == "simt"
              else contextlib.nullcontext()):
            res = fp32_step(kind[0], False, fwd_over_rev=kind != kind[0],
                            amp=True)
        tc = {k_: tc_entry[k_].launches for k_ in keys}
        sc = {k_: simt[k_].launches for k_ in keys}
        # K5 runs only in the d_step's R1 double backward, K2 only in the
        # g_step (G's backward)
        ran = [k_ for k_ in keys if k_ != ("k2" if kind[0] == "d" else "k5")]
        used, unused = (tc, sc) if route == "tc" else (sc, tc)
        if not all(used[k_] for k_ in ran) or any(unused.values()):
            fail(f"bf16 {kind}_step on the {route} route launched tensor-core "
                 f"{tc} and CUDA-core {sc} kernels")
        return res

    def from_plain(kind, res):
        """(max-rel, leaf) of a bf16 step's gated leaves from the fp32 plain
        step: the bf16 noise floor that the route comparison sits on."""
        want = plain_step[kind][1]
        rel = {n_: rel_err(res[1][n_], want[n_]) for n_ in want
               if informative(n_, step_rel[kind]["grad_rel"][n_])}
        worst = max(rel, key=rel.get)
        return rel[worst], worst

    for_r1 = (("d_fwd_over_rev", "d_step +R1 forward-over-reverse"),)
    for keys, kinds in (
            (("k3", "k4"), (("d", "d_step +R1"), ("g", "g_step"))),
            (("k1", "k5"), (("d", "d_step +R1"), ("g", "g_step"))),
            (("k2",), (("g", "g_step"),)),
            (("k6a", "k6b"), for_r1),
            (("k7a", "k7b"), for_r1)):
        names = "/".join(k_.upper() for k_ in keys)
        for kind, label in kinds:
            runs = {r: bf16_step(kind, r, keys) for r in ("tc", "simt")}
            key = f"{kind}_bf16_tc_vs_simt_{'_'.join(keys)}"
            step_rel[key] = compare(
                f"bf16 {label}, tensor-core vs CUDA-core {names}",
                runs["tc"], runs["simt"], tol=STEP_TOL_BF16,
                stable=step_rel[kind])
            step_rel[key]["from_fp32_plain"] = far = {
                r: from_plain(kind, res) for r, res in runs.items()}
            ratio = far["tc"][0] / far["simt"][0]
            step_rel[key]["from_fp32_plain_ratio"] = ratio
            log(f"bf16 {label}, each {names} route vs the fp32 plain step: "
                f"tensor-core {far['tc'][0]:.2e} ({far['tc'][1]}), CUDA-core "
                f"{far['simt'][0]:.2e} ({far['simt'][1]}): ratio "
                f"{ratio:.3f} (limit {FROM_PLAIN_RATIO})")
            if not ratio <= FROM_PLAIN_RATIO:
                fail(f"bf16 {label}: the tensor-core {names} route sits "
                     f"{ratio:.3f}x as far from the fp32 plain step as the "
                     f"CUDA-core one")
            del runs

    # --------------------------------------------------------------- 12
    # the rest of the trainer at the quickstart's full width: gradient
    # accumulation, the chunked R1, recomputation, and train() with its
    # log record, sample grids, save and load
    t_phase = time.perf_counter()
    trainer_report = report["trainer"] = {}
    shapes = SyntheticShapesDataset(QUICKSTART["image_size"],
                                    length=MEM_BATCH, seed=7)
    pool = torch.from_numpy(np.stack([shapes[i] for i in range(MEM_BATCH)])
                            ).to(dev)

    def quickstart(**kw):
        d_cfg = dict(QUICKSTART_D, remat_stages=kw.pop("remat_stages", False))
        kw.setdefault("seed", 0)
        return GigaGAN(generator=QUICKSTART, discriminator=d_cfg,
                       device="cuda", **kw)

    def counted(fn):
        """(fn(), launches of K1-K7b, host ms around it, synchronised)."""
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, read_counts(), (time.perf_counter() - t) * 1e3

    def with_grads(model, metrics):
        return ({k: float(v) for k, v in metrics.items()},
                {n_: p.grad.detach().clone()
                 for n_, p in model.named_parameters()})

    # (a) accumulation: 4 iterations of 2 microbatches of 4, R1 on one
    gan = quickstart(amp=True)
    n_g_attn = sum(st.self_attn is not None for st in gan.G.stages)
    n_d_attn = sum(st.core.attn is not None for st in gan.D.stages)
    exp_d, exp_d_r1, _, exp_g = expected_step_launches(
        len(convs), n_g_attn, n_d_attn, accum=ACCUM)
    mb = BATCH // ACCUM
    accum_steps = []
    reset_counts()
    for i in range(4):
        apply_gp = i == 2
        for kind in ("d", "g"):
            if kind == "d":
                m, got, ms = counted(lambda: gan.train_discriminator_step(
                    pool[:BATCH].reshape(ACCUM, mb, *pool.shape[1:]),
                    grad_accum_every=ACCUM, apply_gradient_penalty=apply_gp,
                    calc_multiscale_loss=True, seed=3000 + i))
                want = exp_d_r1 if apply_gp else exp_d
            else:
                m, got, ms = counted(lambda: gan.train_generator_step(
                    mb, grad_accum_every=ACCUM, calc_multiscale_loss=True,
                    seed=4000 + i))
                want = exp_g
            row = dict(kind=kind, r1=apply_gp, ms=ms, launches=got,
                       losses={k: float(v) for k, v in m.items()})
            accum_steps.append(row)
            log(f"accumulation {ACCUM}x{mb} {kind}_step r1={apply_gp}: "
                f"{ms:.3f} ms, launches {got}, losses "
                + ", ".join(f"{k} {v:.4g}" for k, v in row["losses"].items()))
            if not all(np.isfinite(v) for v in row["losses"].values()):
                fail(f"non-finite losses with accumulation: {row}")
            if got != want:
                fail(f"{kind}_step with accumulation (r1={apply_gp}) launched "
                     f"{got}, the path implies {want}")
            if any(simt_counts().values()):
                fail(f"bf16 calls with accumulation reached the CUDA-core "
                     f"kernels: {simt_counts()}")
    trainer_report["accumulation_steps"] = accum_steps
    del gan
    torch.cuda.empty_cache()

    def accum_step(plain):
        g32 = quickstart()
        with (plain_reference() if plain else contextlib.nullcontext()):
            m = g32.train_discriminator_step(
                pool[:BATCH], grad_accum_every=ACCUM,
                apply_gradient_penalty=True, calc_multiscale_loss=True,
                seed=7)
        res = with_grads(g32.D, m)
        del g32
        torch.cuda.empty_cache()
        return res

    trainer_report["accum_vs_plain_f32"] = compare(
        f"fp32 d_step +R1 with accumulation {ACCUM}x{mb}, kernels vs plain "
        "path", accum_step(False), accum_step(True))

    # (b) the chunked R1 against the unchunked one: the penalty runs on the
    # un-augmented pipeline, equal to the unchunked penalty of an unflipped
    # step
    def r1_step(amp=False, batch=BATCH, **kw):
        g_ = quickstart(amp=amp, **kw)
        m = g_.train_discriminator_step(
            pool[:batch], apply_gradient_penalty=True,
            calc_multiscale_loss=True, seed=7,
            draws=StepDraws(fake_flip=False, real_flip=False))
        res = with_grads(g_.D, m)
        del g_
        torch.cuda.empty_cache()
        return res

    trainer_report["chunk_vs_unchunked_f32"] = compare(
        f"fp32 d_step +R1 gp_chunk={CHUNK} vs unchunked, b={BATCH}",
        r1_step(gp_chunk=CHUNK), r1_step(),
        loss_keys=["gradient_penalty"])

    # (c) recomputation (remat, and D's remat_stages) against none, the
    # draws taken from the same seed: a recomputation that drew its noise
    # again would move the gradients far past REMAT_TOL
    for kind in ("d", "g"):
        runs = []
        for kw in ({}, dict(remat=True, remat_stages=True)):
            g_ = quickstart(**kw)
            if kind == "d":
                m = g_.train_discriminator_step(
                    pool[:BATCH], apply_gradient_penalty=True,
                    calc_multiscale_loss=True, seed=11)
            else:
                m = g_.train_generator_step(BATCH, calc_multiscale_loss=True,
                                            seed=11)
            runs.append(with_grads(g_.D if kind == "d" else g_.G, m))
            del g_
            torch.cuda.empty_cache()
        trainer_report[f"remat_vs_none_f32_{kind}"] = compare(
            f"fp32 {kind}_step{' +R1' if kind == 'd' else ''} remat + "
            "remat_stages vs none, same seed", runs[1], runs[0],
            tol=REMAT_TOL)
        del runs

    # peak memory and ms of a bf16 step at microbatch MEM_BATCH: R1
    # unchunked, chunked, recomputed; and the g_step with and without
    # recomputation
    mem_rows = []
    for kind, label, kw in (
            ("d", "R1", {}),
            ("d", f"R1 gp_chunk={MEM_CHUNK}", dict(gp_chunk=MEM_CHUNK)),
            ("d", "R1 remat_stages", dict(remat_stages=True)),
            ("d", "R1 remat + remat_stages",
             dict(remat=True, remat_stages=True)),
            ("g", "g_step", {}),
            ("g", "g_step remat + remat_stages",
             dict(remat=True, remat_stages=True))):
        g_ = quickstart(amp=True, **kw)
        want = expected_step_launches(
            len(convs), n_g_attn, n_d_attn,
            chunks=MEM_BATCH // kw.get("gp_chunk", MEM_BATCH)
            if "gp_chunk" in kw else 0,
            remat=kw.get("remat", False),
            remat_stages=kw.get("remat_stages", False))
        want = want[1] if kind == "d" else want[3]

        def step(i):
            if kind == "d":
                return g_.train_discriminator_step(
                    pool, apply_gradient_penalty=True,
                    calc_multiscale_loss=True, seed=20 + i)
            return g_.train_generator_step(MEM_BATCH,
                                           calc_multiscale_loss=True,
                                           seed=20 + i)

        step(0)  # warm-up: allocator, cuDNN plans
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times, launches = [], None
        for i in range(1, 4):
            m, launches, ms = counted(lambda: step(i))
            times.append(ms)
        row = dict(kind=kind, label=label, batch=MEM_BATCH,
                   ms=statistics.median(times), ms_all=times,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   base_gib=base / 2 ** 30, launches=launches,
                   expected=want,
                   losses={k: float(v) for k, v in m.items()})
        mem_rows.append(row)
        log(f"memory b{MEM_BATCH} bf16 {kind}_step {label}: peak "
            f"{row['peak_gib']:.3f} GiB (held before the step "
            f"{row['base_gib']:.3f}), {row['ms']:.3f} ms (median of 3: "
            + ", ".join(f"{t_:.3f}" for t_ in times)
            + f"), launches {launches} [{smi}]")
        del g_, m
        gc.collect()
        torch.cuda.empty_cache()
        if launches != want:
            fail(f"b{MEM_BATCH} {kind}_step {label} launched {launches}, "
                 f"the path implies {want}")
        if any(simt_counts().values()):
            fail(f"bf16 calls of {label} reached the CUDA-core kernels: "
                 f"{simt_counts()}")
        if not all(np.isfinite(v) for v in row["losses"].values()):
            fail(f"non-finite losses: {row}")
    trainer_report["memory"] = mem_rows
    peak = {r["label"]: r["peak_gib"] for r in mem_rows}
    if not peak[f"R1 gp_chunk={MEM_CHUNK}"] < peak["R1"]:
        fail(f"the chunked R1's peak is not lower than the unchunked one's: "
             f"{peak}")

    # (d) train() with its log record, then save, load into a fresh
    # trainer, and one more iteration of each from the restored RNG
    models_dir = REPO / "gigagan-models" / "chip_smoke"
    samples_dir = OUT_DIR / "samples"
    records = []
    gan = quickstart(amp=True, log_steps_every=8, log_hook=records.append,
                     num_samples=9, model_folder=str(models_dir),
                     results_folder=str(samples_dir))
    gan.set_dataloader(shapes.get_dataloader(BATCH))
    reset_counts()
    _, train_launches_24, train_ms = counted(lambda: gan.train(24))
    if any(train_launches_24[k] == 0 for k in ("k1", "k2", "k3", "k4", "k5")):
        fail(f"a kernel of the train() path was never launched: "
             f"{train_launches_24}")
    if any(simt_counts().values()):
        fail(f"bf16 calls of train() reached the CUDA-core kernels: "
             f"{simt_counts()}")
    pngs = sorted(p_.name for p_ in samples_dir.glob("*.png"))
    keys = ["step", "G", "MSG", "VG", "D", "MSD", "VD", "GP", "SSL", "CL",
            "MAL", "ms_per_step", "images_per_sec"]
    trainer_report["train"] = dict(records=records, pngs=pngs,
                                   launches=train_launches_24,
                                   wall_ms=train_ms)
    for r_ in records:
        log(f"train() record: {r_} [{smi}]")
    if [r_["step"] for r_ in records] != [1, 8, 16, 24] or any(
            list(r_) != keys for r_ in records):
        fail(f"train() log records: {records}")
    if not all(np.isfinite(v) for r_ in records for v in r_.values()):
        fail("non-finite values in the train() log records")
    if pngs != ["ema-sample-0.png", "sample-0.png"]:
        fail(f"save_sample wrote {pngs}")
    ckpt = models_dir / "resume.ckpt"
    t = time.perf_counter()
    gan.save(ckpt)
    save_s = time.perf_counter() - t
    copies = []
    for _ in range(2):  # the second copy measures the step's own noise
        other = quickstart(amp=True, seed=1, model_folder=str(models_dir),
                           results_folder=str(samples_dir))
        t = time.perf_counter()
        other.load(ckpt)
        load_s = time.perf_counter() - t
        copies.append(other)
    state_equal = all(
        all(torch.equal(a_, b_) for a_, b_ in zip(
            getattr(gan, mod).state_dict().values(),
            getattr(other, mod).state_dict().values()))
        for other in copies for mod in ("G", "G_ema", "D"))
    state_equal &= all(other.steps == gan.steps and other.ema.step ==
                       gan.ema.step and other._rng.bit_generator.state ==
                       gan._rng.bit_generator.state for other in copies)
    for trainer_ in (gan, *copies):
        trainer_.train_discriminator_step(
            pool[:BATCH], apply_gradient_penalty=True,
            calc_multiscale_loss=True)
        trainer_.train_generator_step(BATCH, calc_multiscale_loss=True)
    torch.cuda.synchronize()

    def max_diff(a_, b_):
        return max(float((p_ - q_).detach().abs().max())
                   for mod in ("G", "D")
                   for p_, q_ in zip(getattr(a_, mod).parameters(),
                                     getattr(b_, mod).parameters()))

    resumed, floor = max_diff(gan, copies[0]), max_diff(copies[0], copies[1])
    lr = gan.g_opt.param_groups[0]["lr"]
    trainer_report["resume"] = dict(
        state_equal=state_equal, max_diff_after_step=resumed,
        max_diff_between_loaded=floor, lr=lr, save_s=save_s, load_s=load_s,
        ckpt_gib=ckpt.stat().st_size / 2 ** 30)
    log(f"resume: state equal after load {state_equal}; after one more "
        f"iteration max |continued - resumed| {resumed:.3e}, between two "
        f"resumed copies {floor:.3e} (lr {lr}); checkpoint "
        f"{trainer_report['resume']['ckpt_gib']:.3f} GiB, save "
        f"{save_s:.2f} s, load {load_s:.2f} s")
    del gan, copies, other
    shutil.rmtree(models_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    if not state_equal:
        fail("a loaded trainer's state differs from the saved one's")
    # the card's bf16 steps are not bitwise repeatable (atomic sums in the
    # upsample and index backwards, which Adam's 1/sqrt(v) magnifies where v
    # is small): two resumed copies of one state part by 0.087 lr at most
    # (measured on one H100).  A resumed step is held to 3 times that floor of
    # this run; a load that lost the optimizer state or the RNG moves the
    # parameters by about a whole learning-rate step
    if not resumed <= max(3.0 * floor, 1e-2 * lr):
        fail(f"a resumed iteration departs by {resumed:.3e}, more than 3 "
             f"times the floor {floor:.3e} of two resumed copies")
    # the same resume under torch.use_deterministic_algorithms, in a child
    # process that sets CUBLAS_WORKSPACE_CONFIG before CUDA starts: every
    # op of the step has a backward without float atomics, so the
    # continued and the resumed trainers must be bitwise equal
    t = time.perf_counter()
    child = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()),
         "--deterministic-resume"],
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
        capture_output=True, text=True, timeout=600)
    lines = [ln_ for ln_ in child.stdout.splitlines()
             if ln_.startswith("DETERMINISTIC ")]
    det = json.loads(lines[-1][len("DETERMINISTIC "):]) if lines else None
    trainer_report["deterministic_resume"] = dict(
        result=det, rc=child.returncode, s=time.perf_counter() - t)
    log(f"deterministic resume (child process, rc {child.returncode}, "
        f"{time.perf_counter() - t:.1f} s): {det}")
    if child.returncode != 0 or not det or not det["ok"]:
        log(child.stdout[-3000:])
        log(child.stderr[-3000:])
        fail("the deterministic resume is not bitwise equal, or the mode "
             f"refused an op: {det}")
    log(f"phase 12 (the rest of the trainer): "
        f"{time.perf_counter() - t_phase:.1f} s")

    # --------------------------------------------------------------- 13
    # the text-conditioned recipe at full width: CLIP, the text encoders,
    # cross-attention, the conditional D, the vision-aided D, the
    # matching-aware and contrastive losses
    t_phase = time.perf_counter()
    t2i = report["t2i"] = {}
    t0 = time.perf_counter()
    clip = OpenClipAdapter(seed=0, device="cuda")

    def t2i_gan(**kw):
        kw.setdefault("seed", 0)
        return GigaGAN(generator=T2I_G, discriminator=T2I_D,
                       vision_aided_discriminator=T2I_VD, clip=clip,
                       allow_mock_clip=True, device="cuda", **kw)

    gan = t2i_gan(amp=True)
    sizes = {name: sum(p.numel() for p in mod.parameters()) / 1e6
             for name, mod in (("G", gan.G), ("D", gan.D), ("VD", gan.VD),
                               ("CLIP", clip.model))}
    n_g = len(convs)
    n_ga = sum(st.self_attn is not None for st in gan.G.stages)
    n_da = sum(st.core.attn is not None for st in gan.D.stages)
    n_p = sum(isinstance(m, AdaptiveConv) for st in gan.D.stages
              if st.predictor is not None for m in st.predictor.modules())
    n_v = sum(isinstance(m, AdaptiveConv) for m in gan.VD.modules())
    n_x = sum(st.cross_attn is not None for st in gan.G.stages)
    t2i.update(params_m=sizes, structure=dict(
        g_convs=n_g, g_attn=n_ga, g_cross_attn=n_x, d_attn=n_da,
        predictor_convs=n_p, vd_convs=n_v))
    log(f"text-to-image G+D+VD (+ frozen CLIP): "
        + ", ".join(f"{k} {v:.2f}M" for k, v in sizes.items())
        + f" params; built in {time.perf_counter() - t0:.2f} s; "
        f"{n_x} cross-attention blocks, {n_p} predictor and {n_v} VD "
        "adaptive convs")
    exp_d, exp_d_r1, exp_d_for, exp_g = expected_t2i_launches(
        n_g, n_ga, n_da, n_p, n_v)
    text_data = MockTextImageDataset(T2I_G["image_size"],
                                     length=8 * BATCH, seed=0)
    text_iter = cycle(text_data.get_dataloader(BATCH))
    t2i_batches = []
    for i in range(4):  # each batch's captions embedded once, as train()
        b_ = gan._collect_batch(text_iter, 1)
        b_["real_images"] = torch.from_numpy(b_["real_images"]).to(dev)
        # distinct captions: the matching-aware rows and the contrastive
        # pool then pair each image with another text
        b_["text_embeds"], b_["text_encodings"] = (
            t_[None] for t_ in clip.embed_texts(
                (T2I_CAPTIONS[i:] + T2I_CAPTIONS[:i])[:BATCH]))
        t2i_batches.append(b_)

    def t2i_iteration(i, apply_gp, record=None):
        steps_ = []
        for kind in ("d", "g"):
            batch_ = t2i_batches[(2 * i + (kind == "g")) % len(t2i_batches)]
            before = read_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            if kind == "d":
                m = gan.train_discriminator_step(
                    batch_, apply_gradient_penalty=apply_gp,
                    calc_multiscale_loss=True, seed=5000 + i)
            else:
                m = gan.train_generator_step(
                    batch_, calc_multiscale_loss=True, seed=6000 + i)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            after = read_counts()
            steps_.append(dict(
                kind=kind, r1=apply_gp, ms=ms,
                fwd_over_rev=gan.builder.gp_fwd_over_rev,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                base_gib=base / 2 ** 30,
                losses={k: float(v) for k, v in m.items()},
                launches={k: after[k] - before[k] for k in after}))
        if record is not None:
            record.extend(steps_)
        return steps_

    t2i_iteration(0, True)  # warm-up: allocator, cuDNN plans, both variants
    t2i_iteration(1, False)
    # every K1 and K2 call of the path's run and of its sampling, by the
    # shapes and dtypes of its operands (the dispatchers, which the
    # kernels' autograd Functions look up in their module, are wrapped):
    # each distinct call is held against its plain version below
    path_calls = {}
    k1_dispatch, k2_dispatch = k1.adaptive_conv_fwd, k1.adaptive_conv_bwd_w

    def seen(kname, dispatch):
        def call(*operands):
            key = (kname, *((tuple(t_.shape), t_.dtype) for t_ in operands))
            path_calls[key] = path_calls.get(key, 0) + 1
            return dispatch(*operands)
        return call

    k1.adaptive_conv_fwd = seen("k1", k1_dispatch)
    k1.adaptive_conv_bwd_w = seen("k2", k2_dispatch)
    reset_counts()
    t2i_steps = []
    for i in range(ITERATIONS):
        t2i_iteration(i, i % R1_EVERY == 0, t2i_steps)
    gan.builder.gp_fwd_over_rev = True
    for i in range(2):
        t2i_iteration(ITERATIONS + i, True, t2i_steps)
    t2i_launches = read_counts()
    gan.builder.gp_fwd_over_rev = False
    if any(simt_counts().values()):
        fail(f"bf16 calls of the text-to-image path reached the CUDA-core "
             f"kernels: {simt_counts()}")
    nonzero = {"d": ["vision_aided_divergence", "matching_aware_loss"],
               "g": ["total_vd_divergence", "contrastive_loss"]}
    for s_ in t2i_steps:
        want = exp_g if s_["kind"] == "g" else (
            exp_d if not s_["r1"] else exp_d_for if s_["fwd_over_rev"]
            else exp_d_r1)
        log(f"text-to-image {s_['kind']}_step r1={s_['r1']}"
            f"{' (forward-over-reverse)' if s_['fwd_over_rev'] else ''}: "
            f"{s_['ms']:.3f} ms, peak {s_['peak_gib']:.3f} GiB, launches "
            f"{s_['launches']}, losses "
            + ", ".join(f"{k} {v:.4g}" for k, v in s_["losses"].items()))
        if not all(np.isfinite(v) for v in s_["losses"].values()):
            fail(f"non-finite losses in {s_}")
        zero = [k for k in nonzero[s_["kind"]]
                + (["gradient_penalty"] if s_["r1"] and s_["kind"] == "d"
                   else [])
                if s_["losses"][k] == 0.0]
        if zero:
            fail(f"text-to-image {s_['kind']}_step: {zero} are zero")
        if s_["launches"] != want:
            fail(f"text-to-image {s_['kind']}_step (r1={s_['r1']}) launched "
                 f"{s_['launches']}, the path implies {want}")
    if any(n_ == 0 for n_ in t2i_launches.values()):
        fail(f"a kernel of the text-to-image path was never launched: "
             f"{t2i_launches}")
    log(f"text-to-image path: {ITERATIONS} iterations (R1 on 0 and 4) and "
        f"2 forward-over-reverse R1 iterations, launches {t2i_launches}")
    ror = t2i_steps[:2 * ITERATIONS]
    d_plain = [s_["ms"] for s_ in ror if s_["kind"] == "d" and not s_["r1"]]
    d_r1 = [s_["ms"] for s_ in ror if s_["kind"] == "d" and s_["r1"]]
    g_ms = [s_["ms"] for s_ in ror if s_["kind"] == "g"]
    d_for = [s_["ms"] for s_ in t2i_steps[2 * ITERATIONS:]
             if s_["kind"] == "d"]
    cadence_ms = sum(s_["ms"] for s_ in ror[2 * R1_EVERY:4 * R1_EVERY])
    peak = {key: max(s_["peak_gib"] for s_ in ror if sel(s_))
            for key, sel in (
                ("d_step_r1", lambda s_: s_["kind"] == "d" and s_["r1"]),
                ("d_step", lambda s_: s_["kind"] == "d" and not s_["r1"]),
                ("g_step", lambda s_: s_["kind"] == "g"))}
    t2i["timing"] = dict(
        d_step_ms=statistics.median(d_plain),
        d_step_r1_ms=statistics.median(d_r1),
        d_step_r1_fwd_over_rev_ms=d_for,
        g_step_ms=statistics.median(g_ms), cadence_ms=cadence_ms,
        images_per_s=R1_EVERY * BATCH / (cadence_ms / 1e3),
        peak_gib=peak,
        held_gib=min(s_["base_gib"] for s_ in ror))
    t2i["steps"], t2i["launches"] = t2i_steps, t2i_launches
    tm = t2i["timing"]
    log(f"text-to-image b{BATCH} bf16: d_step {tm['d_step_ms']:.3f} ms "
        f"(median of {len(d_plain)}), d_step+R1 {tm['d_step_r1_ms']:.3f} ms "
        f"(median of {len(d_r1)}; forward-over-reverse "
        + ", ".join(f"{v:.3f}" for v in d_for)
        + f" ms), g_step {tm['g_step_ms']:.3f} ms (median of {len(g_ms)}); "
        f"iterations 4-7 (one R1) {cadence_ms:.3f} ms -> "
        f"{tm['images_per_s']:.2f} images/s; peak memory "
        + ", ".join(f"{k} {v:.3f} GiB" for k, v in peak.items())
        + f" (held before a step {tm['held_gib']:.3f} GiB) [{smi}]")
    if profile:
        profiled("t2i_iter", lambda: t2i_iteration(1, False))
        profiled("t2i_iter_r1", lambda: t2i_iteration(0, True))

    # sampling from captions, batch 1 and 8: K1 per G conv and K3 per G
    # attention per forward; cross-attention and the text encoder run no
    # kernel (77 keys: the plain attention)
    gen_ms = {1: [], BATCH: []}
    reset_counts()
    for i in range(4):
        for bs in (1, BATCH):
            torch.cuda.synchronize()
            t = time.perf_counter()
            img = gan.generate(texts=T2I_CAPTIONS[:bs], seed=i)
            gen_ms[bs].append((time.perf_counter() - t) * 1e3)
            size = T2I_G["image_size"]
            if img.shape != (bs, size, size, 3) or not np.isfinite(
                    img).all():
                fail(f"text-to-image sampling gave {img.shape} / non-finite")
    counts = read_counts()
    per = {k: 0 for k in counts}
    per.update(k1=8 * n_g, k3=8 * n_ga)
    if counts != per:
        fail(f"text-to-image sampling launched {counts}, the path implies "
             f"{per}")
    t2i["sampling"] = dict(
        latency_ms_b1=statistics.median(gen_ms[1][1:]),
        images_per_s_b8=BATCH / (statistics.median(gen_ms[BATCH][1:]) / 1e3),
        ms=gen_ms, launches=counts)
    log(f"text-to-image sampling: batch-1 latency "
        f"{t2i['sampling']['latency_ms_b1']:.3f} ms, batch-{BATCH} "
        f"{t2i['sampling']['images_per_s_b8']:.2f} images/s (medians of 3 "
        f"after one warm-up; caption embedding included) [{smi}]")
    k1.adaptive_conv_fwd, k1.adaptive_conv_bwd_w = k1_dispatch, k2_dispatch
    del gan
    gc.collect()
    torch.cuda.empty_cache()

    # fp32 steps through the kernels against the plain path, from one fresh
    # state: the d_step with the matching rows folded in, d_step + R1 (both
    # forms) and g_step; D's and the VD's gradients, or G's.  The reference
    # is the plain path with its attention in float64: D's self-attention
    # shares q and k, so each to_q gradient is the sum of a q-side and a
    # k-side term several times its size that cancel (measured below), and
    # an fp32 attention leaves a part of that leaf in doubt, in the plain
    # path as in the kernels.  Two fp32 paths would be held to the sum of
    # their roundings; against float64 attention each is held to its own.
    # The plain fp32 path's distance from it is the control
    def attend_f64(q, k, v, *, mask=None, l2_dist=False, scale=None):
        """The plain ``attend``'s algebra (|q|² dropped, |k|² and the key
        mask in one bias row) in float64, rounded back to q's dtype."""
        if scale is None:
            scale = q.shape[-1] ** -0.5
        out_dtype = q.dtype
        q, k, v = q.double(), k.double(), v.double()
        sim = torch.einsum("bhid,bhjd->bhij",
                           q * (2.0 * scale if l2_dist else scale), k)
        if l2_dist:
            sim = sim - scale * (k * k).sum(-1)[..., None, :]
        if mask is not None:
            sim = sim + torch.where(mask, 0.0, ops_attention.NEG_INF)[
                :, None, None, :].double()
        e = torch.exp(sim - sim.amax(-1, keepdim=True).detach())
        out = torch.einsum("bhij,bhjd->bhid", e, v) / e.sum(-1, keepdim=True)
        return out.to(out_dtype)

    @contextlib.contextmanager
    def float64_attention():
        """Every plain attention (``attend``, and ``attend_fused``'s plain
        branch through it) in float64."""
        base = ops.attend
        ops.attend = ops_attention.attend = attend_f64
        try:
            yield
        finally:
            ops.attend = ops_attention.attend = base

    def t2i_fp32_step(kind, plain, fwd_over_rev=False, r1=True,
                      f64_attention=False):
        g32 = t2i_gan(gp_fwd_over_rev=fwd_over_rev)
        with (plain_reference() if plain else contextlib.nullcontext()), \
                (float64_attention() if f64_attention
                 else contextlib.nullcontext()):
            if kind == "d":
                m = g32.train_discriminator_step(
                    t2i_batches[0], apply_gradient_penalty=r1,
                    calc_multiscale_loss=True, seed=7)
                models = (("D", g32.D), ("VD", g32.VD))
            else:
                m = g32.train_generator_step(t2i_batches[0],
                                             calc_multiscale_loss=True,
                                             seed=7)
                models = (("G", g32.G),)
        res = ({k: float(v) for k, v in m.items()},
               {f"{name_}.{n_}": (p.grad if p.grad is not None else
                                  torch.zeros_like(p)).detach().clone()
                for name_, mod in models
                for n_, p in mod.named_parameters()})
        del g32
        gc.collect()
        torch.cuda.empty_cache()
        return res

    def shared_qk_terms():
        """The plain fp32 d_step+R1's q-side and k-side terms of each
        shared-q/k to_q gradient of D (k through a copy of the weight)."""
        g32 = t2i_gan()
        attns = {n_: m_ for n_, m_ in g32.D.named_modules()
                 if isinstance(m_, SelfAttention) and not m_.dot_product}
        for m_ in attns.values():
            m_.k_weight = torch.nn.Parameter(m_.to_q.weight.detach().clone())
        base = SelfAttention.forward

        def split_forward(self, fmap):
            if not hasattr(self, "k_weight"):
                return base(self, fmap)
            b_, h_, w_, _ = fmap.shape
            inner = self.dim_head * self.heads
            fmap = self.norm(fmap)
            q, v = self.to_q(fmap), self.to_v(fmap)
            k = torch.nn.functional.linear(fmap, self.k_weight)
            q, k, v = (t_.reshape(b_, h_ * w_, inner) for t_ in (q, k, v))
            out = ops.attend_fused(q, k, v, heads=self.heads,
                                   null_kv=self.null_kv, l2_dist=True,
                                   scale=self.dim_head ** -0.5)
            return self.to_out(out.reshape(b_, h_, w_, inner))

        SelfAttention.forward = split_forward
        try:
            with plain_reference():
                g32.train_discriminator_step(
                    t2i_batches[0], apply_gradient_penalty=True,
                    calc_multiscale_loss=True, seed=7)
        finally:
            SelfAttention.forward = base
        terms = {}
        for n_, m_ in attns.items():
            qg, kg = m_.to_q.weight.grad, m_.k_weight.grad
            terms[f"D.{n_}.to_q.weight"] = dict(
                norm_q_side=float(qg.norm()), norm_k_side=float(kg.norm()),
                norm_sum=float((qg + kg).norm()),
                max_q_side=float(qg.abs().max()),
                max_k_side=float(kg.abs().max()),
                max_sum=float((qg + kg).abs().max()))
        del g32
        gc.collect()
        torch.cuda.empty_cache()
        return terms

    t2i["shared_qk_terms"] = shared_qk_terms()
    for n_, r_ in t2i["shared_qk_terms"].items():
        log(f"fp32 d_step+R1 (plain), {n_} = q-side + k-side: norms "
            f"{r_['norm_q_side']:.4e} + {r_['norm_k_side']:.4e} -> "
            f"{r_['norm_sum']:.4e}, largest elements {r_['max_q_side']:.4e}"
            f", {r_['max_k_side']:.4e} -> {r_['max_sum']:.4e}")
    t2i["fp32_vs_plain"] = {}
    for kind, label, fwd_over_rev, r1 in (
            ("d", "d_step (matching rows folded)", False, False),
            ("d", "d_step +R1", False, True),
            ("d", "d_step +R1 forward-over-reverse", True, True),
            ("g", "g_step", False, False)):
        ref = t2i_fp32_step(kind, True, fwd_over_rev, r1, True)
        kernels = t2i_fp32_step(kind, False, fwd_over_rev, r1)
        plain32 = t2i_fp32_step(kind, True, fwd_over_rev, r1)
        t2i["fp32_vs_plain"][label] = dict(
            control=compare(
                f"text-to-image fp32 {label}, plain path vs plain with "
                "float64 attention (control)", plain32, ref, tol=None),
            kernels_vs_plain=compare(
                f"text-to-image fp32 {label}, kernels vs plain path",
                kernels, plain32, tol=None),
            kernels=compare(
                f"text-to-image fp32 {label}, kernels vs plain path with "
                "float64 attention", kernels, ref))
        del ref, kernels, plain32

    # K1 and K2 at every shape and dtype the path gave them (the run and the
    # sampling above), against their plain versions on fresh operands of
    # those shapes: the call as the path made it, on the route the rule
    # names, and in fp32 on its route.  The calls the generator does not
    # make (it runs on the batch, or on 1 image when sampling) are timed
    # too: the VD's on 7x7 maps, and the predictors' on images x groups
    # rows (64/h groups at h², as the multiscale expansion gives them),
    # with b images in the g_step, 2b in the main and the matching call of
    # a d_step+R1, 4b in a d_step with the matching rows folded in

    def route_of(kname, call):
        """call() and the one route all its launches took (None if it
        launched nothing or on both)."""
        entries = (("tc", tc_entry), ("simt", simt))
        before = {r: e[kname].launches for r, e in entries}
        res = call()
        ran = [r for r, e in entries if e[kname].launches > before[r]]
        return res, (ran[0] if len(ran) == 1 else None)

    def check_conv_call(key, n_calls, where):
        """One distinct K1 or K2 call of a path (its operands' shapes and
        dtypes, as recorded at the dispatcher) on fresh operands: as the
        path made it and in fp32, each on the route the rule names, against
        the plain version.  Returns (entry, operands, outputs, plain
        function, kernel function)."""
        kname, (xs, xdt), *rest = key
        rows_, h, w_, ci = xs
        if kname == "k1":
            (ws, wdt), (_, adt), (_, ddt) = rest
        else:
            (_, gdt), (ws, wdt), (_, adt) = rest
        banks, co = ws[0], ws[-1]
        xm, w, a, d = conv_operands(rows_, h, w_, ci, co, banks)
        if kname == "k1":
            operands = (xm.to(xdt), w.to(wdt), a.to(adt), d.to(ddt))
            want = k1.adaptive_conv_fwd_plain(xm, w, a, d)
            got, route = route_of("k1", lambda: k1.adaptive_conv_fwd(
                *operands))
            got32, route32 = route_of("k1", lambda: k1.adaptive_conv_fwd(
                xm, w, a, d))
            rel, rel32 = rel_err(got, want), rel_err(got32, want)
            err = max(abs_err(got, want), abs_err(got32, want))
            same, rule = None, k1.conv_uses_tensor_cores
            tol = K1_TOL_BF16 if xdt == bf16 else K1_TOL_F32
            tol32, out = K1_TOL_F32, (got,)
            plain_fn, kernel_fn = (k1.adaptive_conv_fwd_plain,
                                   k1.adaptive_conv_fwd)
        else:
            g = torch.randn(rows_, h, w_, co, device=dev, generator=gen)
            operands = (xm.to(xdt), g.to(gdt), w.to(wdt), a.to(adt))
            want = k1.adaptive_conv_bwd_w_plain(xm, g, w, a)
            got, route = route_of("k2", lambda: k1.adaptive_conv_bwd_w(
                *operands))
            got32, route32 = route_of("k2", lambda: k1.adaptive_conv_bwd_w(
                xm, g, w, a))
            rel = max(map(rel_err, got, want))
            rel32 = max(map(rel_err, got32, want))
            err = max(*map(abs_err, got, want), *map(abs_err, got32, want))
            same = (max(map(rel_err, got, k1.adaptive_conv_bwd_w_plain(
                *operands))) if xdt == bf16 else None)
            rule = k1.bwd_w_uses_tensor_cores
            tol = K2_TOL_BF16 if xdt == bf16 else K2_TOL_F32
            tol32, out = K2_TOL_F32, got
            plain_fn, kernel_fn = (k1.adaptive_conv_bwd_w_plain,
                                   k1.adaptive_conv_bwd_w)
        routes = (route, route32)
        want_routes = tuple("tc" if rule(dt_, ci, co) else "simt"
                            for dt_ in (xdt, torch.float32))
        entry = dict(kernel=kname, rows=rows_, h=h, w=w_, ci=ci, co=co,
                     banks=banks, dtype=str(xdt).split(".")[-1],
                     calls=n_calls, routes=routes, rel=rel, rel_f32=rel32,
                     rel_same=same, max_abs_err=err)
        if routes != want_routes:
            fail(f"{kname} at a {where} shape ran on {routes}; the rule "
                 f"names {want_routes}: {entry}")
        if not (rel <= tol and rel32 <= tol32
                and (same is None or same <= K2_TOL_SAME)):
            fail(f"{kname} disagrees with its plain version at a {where} "
                 f"shape: {entry}")
        del want, got32
        return entry, operands, out, plain_fn, kernel_fn

    def conv_key_order(kv):
        return kv[0][0], -kv[0][1][0][1], kv[0][1][0][0], str(kv[0])

    def log_held(held, where):
        worst = {k_: max((e_ for e_ in held if e_["kernel"] == k_),
                         key=lambda e_: e_["rel"]) for k_ in ("k1", "k2")}
        log(f"K1/K2 held at every call of the {where}: "
            f"{len(held)} distinct shapes and dtypes "
            f"({sum(e_['calls'] for e_ in held)} calls), each on the route "
            f"its rule names; "
            + ", ".join(
                f"worst {k_.upper()} rel {e_['rel']:.2e} (b{e_['rows']} "
                f"{e_['h']}x{e_['w']} {e_['ci']}->{e_['co']} x{e_['banks']} "
                f"{e_['dtype']})" for k_, e_ in worst.items())
            + f"; fp32 at most {max(e_['rel_f32'] for e_ in held):.2e}, "
            f"bf16 K2 on its own inputs at most "
            f"{max(e_['rel_same'] or 0.0 for e_ in held):.2e}")

    t2i_conv_rows, held = [], []
    for key, n_calls in sorted(path_calls.items(), key=conv_key_order):
        entry, operands, out, plain_fn, kernel_fn = check_conv_call(
            key, n_calls, "text-to-image")
        held.append(entry)
        kname, rows_, h, w_, ci, co, banks = (
            entry[k_] for k_ in ("kernel", "rows", "h", "w", "ci", "co",
                                 "banks"))
        route, n_calls = entry["routes"][0], entry["calls"]
        rel, rel32, same = entry["rel"], entry["rel_f32"], entry["rel_same"]
        if (h == 7 or rows_ not in (1, BATCH)) and banks == 2 \
                and entry["dtype"] == "bfloat16":
            flops = 2.0 * rows_ * h * w_ * 9 * ci * co
            entry.update(
                who="VD" if h == 7 else "predictor",
                images=rows_ if h == 7 else rows_ * h // 64,
                ms=time_ms(lambda: kernel_fn(*operands), torch),
                plain_ms=time_ms(lambda: plain_fn(*operands), torch),
                bound=bound(flops, nbytes(*operands, *out)))
            t2i_conv_rows.append(entry)
            log(f"{kname} text-to-image {entry['who']} ({entry['images']} "
                f"images) b{rows_} {h}x{w_} {ci}->{co} bf16 x{n_calls}: "
                f"route {route}, rel {rel:.2e} (fp32 {rel32:.2e}"
                + (f", same inputs {same:.2e}" if same is not None else "")
                + f") | {entry['ms']:.4f} ms (plain {entry['plain_ms']:.4f}, "
                f"bound {entry['bound'][0]:.4f})")
        del operands, out
        torch.cuda.empty_cache()
    log_held(held, "text-to-image path")
    t2i["conv_calls"] = held
    t2i["conv_rows"] = t2i_conv_rows
    del t2i_batches, clip
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 13 (the text-to-image path): "
        f"{time.perf_counter() - t_phase:.1f} s")

    # --------------------------------------------------------------- 14
    # the UNet upsampler recipe of examples/train_upsampler.py at full
    # width: its training iterations, sampling (and a 256 -> 1024
    # request), fp32 steps against the plain path, a video forward, the
    # fused attention chain past its grid limit, and K1-K4 at its shapes
    t_phase = time.perf_counter()
    up = report["upsampler"] = {}
    from gigagan_tpu_torch.models.layers import init_parameters
    from gigagan_tpu_torch.models.unet_upsampler import (
        Attention2D,
        UnetUpsampler,
    )

    def up_gan(**kw):
        kw.setdefault("seed", 0)
        return GigaGAN(generator=UPSAMPLER_G, discriminator=UPSAMPLER_D,
                       train_upsampler=True, device="cuda", **kw)

    t0 = time.perf_counter()
    gan = up_gan(amp=True)
    sizes = {n_: sum(p.numel() for p in m_.parameters()) / 1e6
             for n_, m_ in (("G", gan.G), ("D", gan.D))}
    n_g, n_ga = upsampler_structure(UPSAMPLER_G)
    n_da = sum(st.core.attn is not None for st in gan.D.stages)
    built = (sum(isinstance(m, AdaptiveConv) for m in gan.G.modules()),
             sum(isinstance(m, Attention2D) for m in gan.G.modules()))
    up.update(params_m=sizes, structure=dict(g_convs=n_g, g_attn=n_ga,
                                             d_attn=n_da))
    log(f"upsampler G+D: " + ", ".join(f"{k} {v:.2f}M" for k, v in
                                       sizes.items())
        + f" params; built in {time.perf_counter() - t0:.2f} s; {n_g} "
        f"adaptive convs and {n_ga} full attentions in G, {n_da} "
        "attentions in D")
    if built != (n_g, n_ga):
        fail(f"the upsampler holds {built} adaptive convs and attentions, "
             f"its configuration implies {(n_g, n_ga)}")
    exp_d, exp_d_r1, exp_d_for, exp_g = expected_upsampler_launches(
        UPSAMPLER_G, n_da)
    size = UPSAMPLER_G["image_size"]
    data = MockImageDataset(size, length=4 * BATCH, seed=0)
    up_pool = torch.from_numpy(np.stack(
        [data[i] for i in range(4 * BATCH)])).to(dev)

    def up_iteration(i, apply_gp, record=None):
        steps_ = []
        for kind in ("d", "g"):
            j = (2 * i + (kind == "g")) % 4
            batch_ = up_pool[j * BATCH:(j + 1) * BATCH]
            before = read_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            if kind == "d":
                m = gan.train_discriminator_step(
                    batch_, apply_gradient_penalty=apply_gp,
                    calc_multiscale_loss=True, seed=9000 + i)
            else:
                m = gan.train_generator_step(
                    batch_, calc_multiscale_loss=True, seed=9500 + i)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            after = read_counts()
            steps_.append(dict(
                kind=kind, r1=apply_gp, ms=ms,
                fwd_over_rev=gan.builder.gp_fwd_over_rev,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                base_gib=base / 2 ** 30,
                losses={k: float(v) for k, v in m.items()},
                launches={k: after[k] - before[k] for k in after}))
        if record is not None:
            record.extend(steps_)
        return steps_

    up_iteration(0, True)  # warm-up: allocator, cuDNN plans
    up_iteration(1, False)
    path_calls = {}
    k1.adaptive_conv_fwd = seen("k1", k1_dispatch)
    k1.adaptive_conv_bwd_w = seen("k2", k2_dispatch)
    reset_counts()
    up_steps = []
    for i in range(ITERATIONS):
        up_iteration(i, i % R1_EVERY == 0, up_steps)
    gan.builder.gp_fwd_over_rev = True
    for i in range(2):
        up_iteration(ITERATIONS + i, True, up_steps)
    up_launches = read_counts()
    gan.builder.gp_fwd_over_rev = False
    if any(simt_counts().values()):
        fail(f"bf16 calls of the upsampler path reached the CUDA-core "
             f"kernels: {simt_counts()}")
    for s_ in up_steps:
        want = exp_g if s_["kind"] == "g" else (
            exp_d if not s_["r1"] else exp_d_for if s_["fwd_over_rev"]
            else exp_d_r1)
        log(f"upsampler {s_['kind']}_step r1={s_['r1']}"
            f"{' (forward-over-reverse)' if s_['fwd_over_rev'] else ''}: "
            f"{s_['ms']:.3f} ms, peak {s_['peak_gib']:.3f} GiB, launches "
            f"{s_['launches']}, losses "
            + ", ".join(f"{k} {v:.4g}" for k, v in s_["losses"].items()))
        if not all(np.isfinite(v) for v in s_["losses"].values()):
            fail(f"non-finite losses in {s_}")
        if s_["kind"] == "d" and s_["r1"] and \
                s_["losses"]["gradient_penalty"] == 0.0:
            fail(f"upsampler d_step: the R1 penalty is zero: {s_}")
        if s_["launches"] != want:
            fail(f"upsampler {s_['kind']}_step (r1={s_['r1']}) launched "
                 f"{s_['launches']}, the path implies {want}")
    if any(n_ == 0 for n_ in up_launches.values()):
        fail(f"a kernel of the upsampler path was never launched: "
             f"{up_launches}")
    log(f"upsampler path: {ITERATIONS} iterations (R1 on 0 and 4) and 2 "
        f"forward-over-reverse R1 iterations, launches {up_launches}")
    ror = up_steps[:2 * ITERATIONS]
    d_plain = [s_["ms"] for s_ in ror if s_["kind"] == "d" and not s_["r1"]]
    d_r1 = [s_["ms"] for s_ in ror if s_["kind"] == "d" and s_["r1"]]
    g_ms = [s_["ms"] for s_ in ror if s_["kind"] == "g"]
    d_for = [s_["ms"] for s_ in up_steps[2 * ITERATIONS:]
             if s_["kind"] == "d"]
    cadence_ms = sum(s_["ms"] for s_ in ror[2 * R1_EVERY:4 * R1_EVERY])
    peak = {key: max(s_["peak_gib"] for s_ in up_steps if sel(s_))
            for key, sel in (
                ("d_step_r1", lambda s_: s_["kind"] == "d" and s_["r1"]
                 and not s_["fwd_over_rev"]),
                ("d_step_r1_fwd_over_rev",
                 lambda s_: s_["kind"] == "d" and s_["fwd_over_rev"]),
                ("d_step", lambda s_: s_["kind"] == "d" and not s_["r1"]),
                ("g_step", lambda s_: s_["kind"] == "g"))}
    up["timing"] = tm = dict(
        d_step_ms=statistics.median(d_plain),
        d_step_r1_ms=statistics.median(d_r1),
        d_step_r1_fwd_over_rev_ms=d_for,
        g_step_ms=statistics.median(g_ms), cadence_ms=cadence_ms,
        images_per_s=R1_EVERY * BATCH / (cadence_ms / 1e3), peak_gib=peak,
        held_gib=min(s_["base_gib"] for s_ in ror))
    up["steps"], up["launches"] = up_steps, up_launches
    log(f"upsampler b{BATCH} bf16: d_step {tm['d_step_ms']:.3f} ms "
        f"(median of {len(d_plain)}), d_step+R1 {tm['d_step_r1_ms']:.3f} ms "
        f"(median of {len(d_r1)}; forward-over-reverse "
        + ", ".join(f"{v:.3f}" for v in d_for)
        + f" ms), g_step {tm['g_step_ms']:.3f} ms (median of {len(g_ms)}); "
        f"iterations 4-7 (one R1) {cadence_ms:.3f} ms -> "
        f"{tm['images_per_s']:.2f} images/s; peak memory "
        + ", ".join(f"{k} {v:.3f} GiB" for k, v in peak.items())
        + f" (held before a step {tm['held_gib']:.3f} GiB) [{smi}]")
    if profile:
        profiled("upsampler_iter", lambda: up_iteration(1, False))
        profiled("upsampler_iter_r1", lambda: up_iteration(0, True))

    # sampling, batch 1 and 8: K1 per adaptive conv and K3 per attention of
    # G per forward
    lowres = ops.resize_image_to(up_pool[:BATCH], UPSAMPLER_G[
        "input_image_size"], "nearest").cpu().numpy()
    gen_ms = {1: [], BATCH: []}
    reset_counts()
    for i in range(4):
        for bs in (1, BATCH):
            torch.cuda.synchronize()
            t = time.perf_counter()
            img = gan.generate(lowres[:bs], seed=i)
            gen_ms[bs].append((time.perf_counter() - t) * 1e3)
            if img.shape != (bs, size, size, 3) or not np.isfinite(
                    img).all():
                fail(f"upsampler sampling gave {img.shape} / non-finite")
    counts = read_counts()
    per = {k: 0 for k in counts}
    per.update(k1=8 * n_g, k3=8 * n_ga)
    if counts != per:
        fail(f"upsampler sampling launched {counts}, the path implies {per}")
    up["sampling"] = dict(
        latency_ms_b1=statistics.median(gen_ms[1][1:]),
        images_per_s_b8=BATCH / (statistics.median(gen_ms[BATCH][1:]) / 1e3),
        ms=gen_ms, launches=counts)
    log(f"upsampler sampling 64 -> 256: batch-1 latency "
        f"{up['sampling']['latency_ms_b1']:.3f} ms, batch-{BATCH} "
        f"{up['sampling']['images_per_s_b8']:.2f} images/s (medians of 3 "
        f"after one warm-up) [{smi}]")
    del gan
    gc.collect()
    torch.cuda.empty_cache()

    # a 256 -> 1024 request with the same widths: K1 on 1024² maps, K3 at
    # 16384 tokens
    big = GigaGAN(generator=UPSAMPLER_1K, train_upsampler=True, amp=True,
                  device="cuda", seed=0)
    lowres_1k = np.random.default_rng(0).random(
        (1, 256, 256, 3)).astype(np.float32)
    big.generate(lowres_1k, seed=0)  # warm-up
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    big_ms = []
    for i in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        img = big.generate(lowres_1k, seed=1 + i)
        big_ms.append((time.perf_counter() - t) * 1e3)
    counts = read_counts()
    if img.shape != (1, 1024, 1024, 3) or not np.isfinite(img).all():
        fail(f"the 256 -> 1024 request gave {img.shape} / non-finite")
    per = {k: 0 for k in counts}
    per.update(k1=3 * n_g, k3=3 * n_ga)
    if counts != per:
        fail(f"the 256 -> 1024 request launched {counts}, the path implies "
             f"{per}")
    up["sampling_1k"] = dict(
        latency_ms=statistics.median(big_ms), ms=big_ms,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        held_gib=base / 2 ** 30, launches=counts)
    log(f"upsampler 256 -> 1024, batch 1: latency "
        f"{up['sampling_1k']['latency_ms']:.3f} ms (median of 3: "
        + ", ".join(f"{v:.3f}" for v in big_ms)
        + f"), peak {up['sampling_1k']['peak_gib']:.3f} GiB (held "
        f"{up['sampling_1k']['held_gib']:.3f}) [{smi}]")
    k1.adaptive_conv_fwd, k1.adaptive_conv_bwd_w = k1_dispatch, k2_dispatch
    del big
    gc.collect()
    torch.cuda.empty_cache()

    # fp32 steps through the kernels against the plain path with float64
    # attention (phase 13's reference; the plain fp32 path is the
    # control), from one fresh state: d_step+R1 in both forms and g_step
    def up_fp32_step(kind, plain, fwd_over_rev=False, f64_attention=False):
        g32 = up_gan(gp_fwd_over_rev=fwd_over_rev)
        batch_ = up_pool[:UP_FP32_BATCH]
        with (plain_reference() if plain else contextlib.nullcontext()), \
                (float64_attention() if f64_attention
                 else contextlib.nullcontext()):
            if kind == "d":
                m = g32.train_discriminator_step(
                    batch_, apply_gradient_penalty=True,
                    calc_multiscale_loss=True, seed=7)
                models = (("D", g32.D),)
            else:
                m = g32.train_generator_step(batch_,
                                             calc_multiscale_loss=True,
                                             seed=7)
                models = (("G", g32.G),)
        res = ({k: float(v) for k, v in m.items()},
               {f"{name_}.{n_}": (p.grad if p.grad is not None else
                                  torch.zeros_like(p)).detach().clone()
                for name_, mod in models
                for n_, p in mod.named_parameters()})
        del g32
        gc.collect()
        torch.cuda.empty_cache()
        return res

    up["fp32_vs_plain"] = {}
    for kind, label, fwd_over_rev in (
            ("d", "d_step +R1", False),
            ("d", "d_step +R1 forward-over-reverse", True),
            ("g", "g_step", False)):
        ref = up_fp32_step(kind, True, fwd_over_rev, True)
        kernels = up_fp32_step(kind, False, fwd_over_rev)
        plain32 = up_fp32_step(kind, True, fwd_over_rev)
        up["fp32_vs_plain"][label] = dict(
            control=compare(
                f"upsampler fp32 b{UP_FP32_BATCH} {label}, plain path vs "
                "plain with float64 attention (control)", plain32, ref,
                tol=None),
            kernels_vs_plain=compare(
                f"upsampler fp32 b{UP_FP32_BATCH} {label}, kernels vs plain "
                "path", kernels, plain32, tol=None),
            kernels=compare(
                f"upsampler fp32 b{UP_FP32_BATCH} {label}, kernels vs plain "
                "path with float64 attention", kernels, ref))
        del ref, kernels, plain32

    # the video net, fp32, one clip: every K3 launch of the forward takes
    # at most MAX_BATCH rows, and the last up stage's temporal attention
    # (256² rows) splits
    k3_batches = []
    k3_entries = {r: getattr(k3, f"flash_attention_fused_fwd_{r}")
                  for r in ("tc", "simt")}

    def k3_batch_of(entry):
        def call(q, *rest):
            k3_batches.append(q.shape[0])
            return entry(q, *rest)
        call.launches = 0  # the entry counts on the name it is called by
        return call

    vid = UnetUpsampler(**UPSAMPLER_VIDEO)
    init_parameters(vid, torch.Generator().manual_seed(0))
    vid.to(dev)
    vgen = torch.Generator(device=dev).manual_seed(3)
    inp = UPSAMPLER_VIDEO["input_image_size"]
    clip_in = torch.rand(1, VIDEO_FRAMES, inp, inp, 3, device=dev,
                         generator=vgen)
    vnoise = torch.randn(1, UPSAMPLER_VIDEO["style_network"]["dim"],
                         device=dev, generator=vgen)
    for r_, e_ in k3_entries.items():
        setattr(k3, f"flash_attention_fused_fwd_{r_}", k3_batch_of(e_))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        with torch.no_grad():
            got = vid(clip_in, noise=vnoise)
        torch.cuda.synchronize()
        video_ms = (time.perf_counter() - t) * 1e3
    finally:
        for r_, e_ in k3_entries.items():
            setattr(k3, f"flash_attention_fused_fwd_{r_}", e_)
    video_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.no_grad(), plain_reference():
        want = vid(clip_in, noise=vnoise)
    # frames double at every up stage and halve at every down stage that
    # pools
    stages = len(UPSAMPLER_VIDEO["dim_mults"])
    pools = stages - int(np.log2(UPSAMPLER_VIDEO["image_size"] // inp))
    frames = VIDEO_FRAMES * 2 ** stages // 2 ** pools
    rel = rel_err(got, want)
    up["video"] = dict(shape=list(got.shape), rel=rel, ms=video_ms,
                       peak_gib=video_peak,
                       k3_batches=sorted(set(k3_batches)),
                       k3_launches=len(k3_batches))
    log(f"upsampler video fp32, {VIDEO_FRAMES} frames {inp}² -> "
        f"{tuple(got.shape)}: kernels vs plain path rel {rel:.2e} (tol "
        f"{VIDEO_TOL}), {video_ms:.1f} ms, peak {video_peak:.3f} GiB, "
        f"{len(k3_batches)} K3 launches, batches "
        f"{sorted(set(k3_batches))} [{smi}]")
    if tuple(got.shape) != (1, frames, 256, 256, 3) or not bool(
            torch.isfinite(got).all()) or not rel <= VIDEO_TOL:
        fail(f"the video forward disagrees: {up['video']}")
    if max(k3_batches, default=0) > k3.MAX_BATCH or \
            k3.MAX_BATCH not in k3_batches:
        fail(f"the video forward's K3 launches took batches "
             f"{sorted(set(k3_batches))}: the 65536-row temporal attention "
             "did not split at the grid limit")
    del vid, got, want, clip_in
    gc.collect()
    torch.cuda.empty_cache()

    # K3, K4 and K5 past the grid limit: a batch of 65536 + 8 at the video
    # temporal attention's size (16 tokens), with and without the null
    # token, fp32 and bf16; each call must run as two launches
    split_rows = []
    for null in (False, True):
        for dtype in (torch.float32, bf16):
            args = attn_operands(SPLIT_ROWS, HEADS, 16, 16, DIM_HEAD, null,
                                 null, dtype)
            q, k_pre, v, bias, nullk, nullv, null_bias, _ = args
            route = "tc" if k3.uses_tensor_cores(dtype, DIM_HEAD) else "simt"
            route5 = ("tc" if so.so_uses_tensor_cores(dtype, DIM_HEAD)
                      else "simt")
            entries = {k_: (tc_entry if r_ == "tc" else simt)[k_]
                       for k_, r_ in (("k3", route), ("k4", route),
                                      ("k5", route5))}
            before = {k_: e_.launches for k_, e_ in entries.items()}
            out, lse = k3.flash_attention_fused_fwd(*args)
            o_want, l_want = k3.flash_attention_fused_fwd_plain(*args)
            g = torch.randn(q.shape, device=dev, generator=gen).to(dtype)
            bargs = (q, k_pre, v, bias, nullk, nullv, null_bias, g, out,
                     lse, HEADS)
            got4 = so.flash_attention_fused_bwd(*bargs)
            want4 = so.flash_attention_fused_bwd_plain(*bargs)
            cots = [None if w_ is None else torch.randn(
                w_.shape, device=dev, generator=gen).to(w_.dtype)
                for w_ in want4]
            args5 = (*bargs[:8], lse, *cots, HEADS)
            got5 = so.flash_attention_so_bwd2(*args5)
            want5 = so.flash_attention_so_bwd2_plain(*args5)
            torch.cuda.synchronize()
            ran = {k_: e_.launches - before[k_] for k_, e_ in entries.items()}
            row = dict(
                b=SPLIT_ROWS, n=16, null=null, dtype=dtype_name(dtype),
                route=route, route_k5=route5, launches=ran,
                rel_k3=max(rel_err(out, o_want), rel_err(lse, l_want)),
                rel_k4=max(rel_err(a_, w_) for a_, w_ in zip(got4, want4)
                           if w_ is not None),
                rel_k5=max(rel_err(a_, w_) for a_, w_ in zip(got5, want5)
                           if w_ is not None))
            split_rows.append(row)
            log(f"K3-K5 at b{SPLIT_ROWS} n16 null={null} {row['dtype']} "
                f"({route}, K5 {route5}): launches {ran}, rel K3 "
                f"{row['rel_k3']:.2e} K4 {row['rel_k4']:.2e} K5 "
                f"{row['rel_k5']:.2e}")
            if ran != {"k3": 2, "k4": 2, "k5": 2} or not (
                    row["rel_k3"] <= K3_TOL and row["rel_k4"] <= K4_TOL
                    and row["rel_k5"] <= K5_TOL):
                fail(f"K3-K5 past the grid limit: {row}")
            del args, bargs, args5, out, lse, o_want, l_want, got4, want4
            del got5, want5, cots, q, k_pre, v, g
            torch.cuda.empty_cache()
    up["split"] = split_rows

    # K1 and K2 at every shape and dtype of the run, the sampling and the
    # 1024 request, against their plain versions; the bf16 shapes timed
    # beside the plain version and (K1) cuDNN's grouped conv
    up_conv_rows, held = [], []
    for key, n_calls in sorted(path_calls.items(), key=conv_key_order):
        entry, operands, out, plain_fn, kernel_fn = check_conv_call(
            key, n_calls, "upsampler")
        held.append(entry)
        if entry["dtype"] == "bfloat16" and entry["banks"] == 2:
            rows_, h, w_, ci, co = (entry[k_] for k_ in (
                "rows", "h", "w", "ci", "co"))
            flops = 2.0 * rows_ * h * w_ * 9 * ci * co
            entry.update(
                ms=time_ms(lambda: kernel_fn(*operands), torch),
                plain_ms=time_ms(lambda: plain_fn(*operands), torch),
                bound=bound(flops, nbytes(*operands, *out)))
            if entry["kernel"] == "k1":
                xb, w, a, d = operands
                wg = torch.einsum("bn,nijcd,bd->bdcij", a, w.float(),
                                  d).reshape(rows_ * co, ci, 3, 3).to(bf16)
                xg = xb.permute(0, 3, 1, 2).reshape(1, rows_ * ci, h, w_)
                entry["library_ms"] = time_ms(
                    lambda: torch.nn.functional.conv2d(
                        xg, wg, padding=1, groups=rows_), torch)
                del wg, xg
            up_conv_rows.append(entry)
            log(f"{entry['kernel']} upsampler b{rows_} {h}x{w_} {ci}->{co} "
                f"bf16 x{entry['calls']}: route {entry['routes'][0]}, rel "
                f"{entry['rel']:.2e} | {entry['ms']:.4f} ms (plain "
                f"{entry['plain_ms']:.4f}"
                + (f", cuDNN grouped conv {entry['library_ms']:.4f}"
                   if "library_ms" in entry else "")
                + f", bound {entry['bound'][0]:.4f}) [{smi}]")
        del operands, out
        torch.cuda.empty_cache()
    log_held(held, "upsampler path")
    up["conv_calls"], up["conv_rows"] = held, up_conv_rows

    # K3 and K4 at G's three attention shapes (8 heads of 64, dot product,
    # no null token; 5 layers at 1024, 256, 64, 256 and 1024 tokens), and
    # K3 at the 1024 request's 16384 tokens, beside SDPA
    up_attn_rows = []
    for b, n in ((BATCH, 1024), (BATCH, 256), (BATCH, 64), (1, 16384)):
        args = attn_operands(b, HEADS, n, n, DIM_HEAD, False, False, bf16)
        q = args[0]
        o_want, l_want = k3.flash_attention_fused_fwd_plain(*args)
        out, lse = k3.flash_attention_fused_fwd(*args)
        row = dict(b=b, n=n, rel_k3=max(rel_err(out, o_want),
                                        rel_err(lse, l_want)),
                   k3_ms=time_ms(lambda: k3.flash_attention_fused_fwd(
                       *args), torch),
                   k3_plain_ms=time_ms(
                       lambda: k3.flash_attention_fused_fwd_plain(*args),
                       torch),
                   k3_bound=attn_bound(2, b * HEADS, n, n, DIM_HEAD,
                                       nbytes(*args[:-1], out, lse)))
        sd = sdpa_operands(torch, *args)
        del o_want, l_want
        if n <= 1024:
            g = torch.randn(q.shape, device=dev, generator=gen).to(bf16)
            bargs = (*args[:7], g, out, lse, HEADS)
            want4 = so.flash_attention_fused_bwd_plain(*bargs)
            got4 = so.flash_attention_fused_bwd(*bargs)
            row.update(
                rel_k4=max(rel_err(a_, w_) for a_, w_ in zip(got4, want4)
                           if w_ is not None),
                k4_ms=time_ms(lambda: so.flash_attention_fused_bwd(*bargs),
                              torch),
                k4_plain_ms=time_ms(
                    lambda: so.flash_attention_fused_bwd_plain(*bargs),
                    torch),
                k4_bound=attn_bound(5, b * HEADS, n, n, DIM_HEAD, nbytes(
                    *bargs[:-1], *(t_ for t_ in got4 if t_ is not None))))
            row["sdpa_ms"], row["sdpa_bwd_ms"], row["sdpa_note"] = \
                sdpa_times(torch, *sd, g)
            del g, bargs, want4, got4
        else:
            row["sdpa_ms"], _, row["sdpa_note"] = sdpa_times(torch, *sd)
        up_attn_rows.append(row)
        log(f"K3/K4 upsampler G b{b} H{HEADS} n{n} d{DIM_HEAD} bf16: rel K3 "
            f"{row['rel_k3']:.2e}"
            + (f" K4 {row['rel_k4']:.2e}" if "rel_k4" in row else "")
            + f" | K3 {row['k3_ms']:.4f} ms (plain {row['k3_plain_ms']:.4f}"
            f", SDPA {row['sdpa_ms']}, bound {row['k3_bound'][0]:.4f})"
            + (f", K4 {row['k4_ms']:.4f} ms (plain "
               f"{row['k4_plain_ms']:.4f}, SDPA backward "
               f"{row['sdpa_bwd_ms']}, bound {row['k4_bound'][0]:.4f})"
               if "k4_ms" in row else "") + f" [{smi}]")
        if not (row["rel_k3"] <= K3_TOL
                and row.get("rel_k4", 0.0) <= K4_TOL):
            fail(f"K3/K4 disagree at an upsampler shape: {row}")
        del args, out, lse, sd, q
        torch.cuda.empty_cache()
    up["attention"] = up_attn_rows
    del up_pool
    gc.collect()
    torch.cuda.empty_cache()
    up["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14 (the upsampler path): {up['seconds']:.1f} s")

    # --------------------------------------------------------------- 15
    mult = {}
    for _, h, ci, co in convs:
        mult[(h, ci, co)] = mult.get((h, ci, co), 0) + 1

    def total(rows, key):
        """Σ over (weight, row) of row[key]; None if a row has none."""
        vals = [r.get(key) for _, r in rows]
        if any(v is None for v in vals):
            return None
        return sum(w * v for (w, _), v in zip(rows, vals))

    def timing(rows, suffix=""):
        """ms, plain_ms, library_ms, bound_ms, bound_by over weighted rows
        (bound_by: what bounds the row of the largest bound)."""
        top = max(rows, key=lambda wr: wr[0] * wr[1]["bound_ms"])[1]
        return dict(ms=total(rows, "ms" + suffix),
                    plain_ms=total(rows, "plain_ms" + suffix),
                    library_ms=total(rows, "library_ms" + suffix),
                    bound_ms=total(rows, "bound_ms"),
                    bound_by=top["bound_by"])

    conv_rows = [(mult[s_], r) for s_, r in k1_rows.items()]
    k2_weighted = [(mult[s_], r) for s_, r in k2_rows.items()]
    d_step = {kn: [(1, r) for r in rows if r["who"] == "D d_step"
                   and r["dtype"] == "bfloat16"]
              for kn, rows in (("k3", k3_rows), ("k4", k4_rows))}
    r1_bf16 = [(1, r) for r in k5_rows if r["dtype"] == "bfloat16"
               and "ms" in r]
    # K1-K5: bf16 on the tensor-core kernels, the CUDA-core
    # kernels (fp32, other channel counts or head dims) beside them
    kernels = [
        dict(name="adaptive_conv_fwd", route="cuda",
             source="gigagan_tpu_torch/csrc/adaptive_conv_fwd_tc.cu",
             replaces="gigagan_tpu/ops/pallas/adaptive_conv.py:86",
             launches=t2i_launches["k1"],
             launches_unconditional=train_launches["k1"],
             launches_upsampler=up_launches["k1"],
             max_abs_err=max([max(r["abs_f32"], r["abs_bf16"])
                              for r in k1_rows.values()]
                             + [r["abs"] for r in k1_extra]),
             **timing(conv_rows, "_bf16"),
             simt_source="gigagan_tpu_torch/csrc/adaptive_conv_fwd.cu",
             simt_ms=total(conv_rows, "simt_ms_bf16")),
        dict(name="adaptive_conv_bwd_w", route="cuda",
             source="gigagan_tpu_torch/csrc/adaptive_conv_bwd_w_tc.cu",
             replaces="gigagan_tpu/ops/pallas/adaptive_conv.py:269",
             launches=t2i_launches["k2"],
             launches_unconditional=train_launches["k2"],
             launches_upsampler=up_launches["k2"],
             max_abs_err=max([max(r["abs_f32"], r["abs_bf16"])
                              for r in k2_rows.values()]
                             + [r["abs"] for r in k2_extra]
                             + [report["k2_banks"]["abs"]]),
             **timing(k2_weighted, "_bf16"),
             simt_source="gigagan_tpu_torch/csrc/adaptive_conv_bwd_w.cu",
             simt_ms=total(k2_weighted, "simt_ms_bf16"),
             device_ms=total(k2_weighted, "device_ms_bf16"),
             simt_device_ms=total(k2_weighted, "simt_device_ms_bf16")),
        dict(name="flash_attention_fused_fwd", route="cuda",
             source="gigagan_tpu_torch/csrc/flash_attention_fused_fwd_tc.cu",
             replaces="gigagan_tpu/ops/pallas/flash_attention_fused.py:95",
             launches=t2i_launches["k3"],
             launches_unconditional=train_launches["k3"],
             launches_upsampler=up_launches["k3"],
             max_abs_err=max(max(r["abs_out"], r["abs_lse"])
                             for r in k3_rows),
             **timing(d_step["k3"]),
             simt_source="gigagan_tpu_torch/csrc/flash_attention_fused_fwd.cu",
             simt_ms=total(d_step["k3"], "simt_ms")),
        dict(name="flash_attention_fused_bwd", route="cuda",
             source="gigagan_tpu_torch/csrc/flash_attention_fused_bwd_tc.cu",
             replaces="gigagan_tpu/ops/pallas/flash_attention_so.py:191",
             launches=t2i_launches["k4"],
             launches_unconditional=train_launches["k4"],
             launches_upsampler=up_launches["k4"],
             max_abs_err=max(r["abs"] for r in k4_rows),
             **timing(d_step["k4"]),
             simt_source="gigagan_tpu_torch/csrc/flash_attention_fused_bwd.cu",
             simt_ms=total(d_step["k4"], "simt_ms")),
        dict(name="flash_attention_so_bwd2", route="cuda",
             source="gigagan_tpu_torch/csrc/flash_attention_so_bwd2_tc.cu",
             replaces="gigagan_tpu/ops/pallas/flash_attention_so.py:297",
             launches=t2i_launches["k5"],
             launches_unconditional=train_launches["k5"],
             launches_upsampler=up_launches["k5"],
             max_abs_err=max(r["abs"] for r in k5_rows),
             **timing(r1_bf16),
             simt_source="gigagan_tpu_torch/csrc/flash_attention_so_bwd2.cu",
             simt_ms=total(r1_bf16, "simt_ms")),
    ]
    # K6a-K7b: launches from the forward-over-reverse run, times summed
    # over φ's two attentions in bf16, on the tensor-core kernels (K6a/K6b
    # on K3's/K4's), their CUDA-core kernels beside them
    phi_bf16 = [r for r in hv_rows if r["who"] == "phi"
                and r["dtype"] == "bfloat16"]
    for key, name_, source, replaces in (
        ("k6a", "flash_attention_fwd", "flash_attention_fused_fwd_tc",
         "flash_attention.py:118"),
        ("k6b", "flash_attention_bwd", "flash_attention_fused_bwd_tc",
         "flash_attention.py:143"),
        ("k7a", "flash_attention_hv_jvp", "flash_attention_hv_jvp_tc",
         "flash_attention_hv.py:76"),
        ("k7b", "flash_attention_hv_bwd", "flash_attention_hv_bwd_tc",
         "flash_attention_hv.py:110"),
    ):
        rows = [(1, dict(r[key], library_ms=r.get(f"{key}_library"),
                         bound_ms=r[f"{key}_bound"][0],
                         bound_by=r[f"{key}_bound"][1])) for r in phi_bf16]
        kernels.append(dict(
            name=name_, route="cuda",
            source=f"gigagan_tpu_torch/csrc/{source}.cu",
            replaces=f"gigagan_tpu/ops/pallas/{replaces}",
            launches=t2i_launches[key],
            launches_unconditional=for_launches[key],
            launches_upsampler=up_launches[key],
            max_abs_err=max([r[key]["abs"] for r in hv_rows]
                            + [r[key]["abs"] for r in k6_masked
                               if key in r]),
            **timing(rows),
            simt_source=f"gigagan_tpu_torch/csrc/{name_}.cu",
            simt_ms=total(rows, "simt_ms")))
    # launches: the text-to-image path's run (phase 13: 8 iterations, R1
    # reverse-over-reverse on two, then 2 forward-over-reverse R1
    # iterations); launches_unconditional: phase 9's (K1-K5) or phase 10's
    # (K6a-K7b) 8 iterations of the quickstart pair; launches_upsampler:
    # phase 14's run of the upsampler recipe (as phase 13's)
    report["kernels"] = kernels
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if "--deterministic-resume" in sys.argv[1:]:
        sys.exit(deterministic_resume())
    main()
