#!/usr/bin/env python3
"""Check of the PyTorch port (``gigagan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase, one card

It times nothing: the port's speed is the benchmark's
(``portbench/``; PERF.md and PERF_LEDGER.jsonl).  Each phase is a function,
``phase_<N>_<what>(ctx)``, that ends the run with ``chip_smoke: FAIL`` at
the first check that does not hold; ``main()`` calls them in the order
below and logs each phase's seconds (``phase N: ... s``).  One phase can
be rehearsed by making a ``Ctx`` and calling its function (a phase that
reads an earlier one's result takes it as an argument).

Phases:

1. find the card (fails without CUDA) and print its name and power limit;
2. build the CUDA kernels from ``gigagan_tpu_torch/csrc`` with nvcc, one
   process per source, all at once, and check in their SASS that the
   tensor-core K1, K2, K3, K4, K5, K7a and K7b run ``HGMMA`` (``wgmma``) fed
   by ``UTMALDG`` (TMA), for K5, K7a and K7b in every kernel, those built
   for head dim 128 among them, and the linear attention ``HMMA``
   (``mma.sync``) fed by ``LDSM`` and ``LDGSTS`` (``ldmatrix``,
   ``cp.async``);
3. hold kernel K1 (adaptive conv) against its plain PyTorch version at
   every 3x3 conv shape of the 256px generator, batch 8: fp32 (TF32 off) on
   the CUDA-core kernel, bf16 with fp32 and with bf16 banks on the
   tensor-core one; and at extra rows (a ragged 12x20 map, 64 -> 48, with
   1 and 2 banks, and 4 banks as the conv pair's double backward makes);
4. hold kernel K3 (fused-heads attention) against its plain version at the
   six attention shapes of the training path (G's dot product, D's L2 in
   the d_step and the g_step) with the null key/value, fp32 (CUDA-core
   kernel) and bf16 (tensor-core kernel), and at small ragged rows (300
   queries, 200 keys) for d = 64 and 128 (tensor cores in bf16) and 80
   (CUDA cores), with and without the null token, dot and L2;
5. drive the sampling path: the README quickstart generator (256px, 30M
   params, bf16) answers generate(batch_size=8) and generate(batch_size=1)
   three times each: the first call of each runs G eagerly, the second
   captures G's forward as a CUDA graph and replays it, the third replays
   it (``train/sample_graph.py``); the kernels' launch counts, which
   Python counts and a replay does not, must show 15 K1, 15 demodulation
   and 2 K3 launches for each of the two forwards issued from Python per
   batch size, and both graphs must be held; one fp32 forward through the
   kernels is held against the plain path on the card;
18. (after phase 5) the sampler's CUDA graph, the demodulation and the
    linear-attention kernels: the card's tests of
    ``tests/test_torch_sample_graph.py``, ``tests/test_torch_demod.py`` and
    ``tests/test_torch_linear_attention.py`` (marked ``cuda``) in a child
    pytest: the linear-attention kernel at every linear-attention shape of
    the upsampler configurations, ragged, repeating bitwise, replayed in a
    graph bitwise and on every call of an eager ``generate``; the
    demodulation kernel at every demodulated conv shape of the quickstart,
    text-to-image and upsampler G and at ragged ones, batch 1, 8 and 32,
    repeating bitwise, replayed in a graph bitwise, and on all 15 convs of
    an eager ``generate``; replayed ``generate`` bitwise equal to G's eager
    forward for the quickstart G and a small text-conditioned G at batch 1
    and 4 over 3 seeds, replays after an in-place weight update and after
    ``load`` following the new weights, and a capture under
    ``torch.cuda.set_sync_debug_mode("error")``;
6. hold K2 (weight gradient; fp32 on the CUDA-core kernel, bf16 on the
   tensor-core one, every bf16 launch checked to land there) and K1 as the
   input gradient (tensor cores in bf16), through the conv Function's
   backward, against plain PyTorch at the same 15 shapes; K2 at extra rows
   (ragged 12x20 maps at 16 -> 16, 16 -> 32, 32 -> 16 and 64 -> 48, and
   64 -> 40 on the CUDA cores by the rule; 1, 2 and 4 banks; batch 1),
   each launch on the route its rule names; and K2 at 8 banks (groups of
   at most 4 on the CUDA cores, 2 on the tensor cores);
7. the same for K4 (attention backward), and K5 (its adjoint; tensor cores
   in bf16 at d = 64 and 128) at the d_step's R1 shapes and at those of
   phase 17's d = 128 discriminator (bf16, each launch on the tensor
   cores), and at the small rows (ragged with and without the null token,
   dot and L2; d = 128, and 80 on the CUDA cores);
8. hold K6a/K6b (split-heads attention and its backward; bf16 at d = 64
   and 128 on the tensor-core kernels of K3/K4 with one head, the rest on
   CUDA cores) and K7a/K7b (its jvp and the jvp's backward; bf16 at d = 64
   and 128 on their tensor-core kernels, the rest on CUDA cores) against
   their plain versions at the two attention shapes of the
   forward-over-reverse R1 surrogate (L2, the null token as an extra key),
   fp32 and bf16, at the same pair for phase 17's d = 128 discriminator
   (bf16), and at small masked shapes (dot product, and head dims 128 and
   80), each call on the route its rule names; all four also at masked
   shapes (head dims 64 and 128) where one sample has every key masked, on
   both routes, whose outputs must be finite;
9. drive the training path: the quickstart G+D pair (256px, bf16, batch 8)
   takes 8 iterations of train_discriminator_step + train_generator_step
   with R1 on iterations 0 and 4; every loss must be finite and every
   step's K1-K7b launch counts those the path implies (K5 on R1 steps
   only), every bf16 launch of a kernel with two routes on its tensor-core
   kernel;
10. the same 8 iterations with the R1 penalty taken forward-over-reverse
    (``GigaGAN(gp_fwd_over_rev=True)``): K6a, K6b, K7a and K7b on R1
    d_steps only, K5 never, every K6a-K7b launch on the tensor cores;
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
    from the fp32 plain step is logged, and the tensor-core route's may
    be at most FROM_PLAIN_RATIO times the CUDA-core route's;
17. (after phase 11) the quickstart G beside a discriminator with 4 heads
    of 128 (``QUICKSTART_D128``; 256px, batch 8, bf16): a d_step+R1 in
    each form and a g_step from the fresh state, every loss finite and
    every K1-K7b launch on the tensor cores in the counts the path implies;
    each R1 form through the tensor-core K5 (reverse-over-reverse) or
    K7a/K7b (forward-over-reverse) against the CUDA-core ones patched in,
    and each route's distance from the fp32 plain step, the tensor-core
    one at most FROM_PLAIN_RATIO times the CUDA-core one's, as phase 11;
    and, in phase 12(d)'s deterministic child, two d_steps+R1 in each form
    from one state and one seed with bitwise-equal gradients (no published
    configuration builds D with heads of 128: the phase checks the range
    the JAX kernels accept);
12. the rest of the trainer at the quickstart's full width (bf16 unless
    named fp32): (a) 4 iterations with ``grad_accum_every=2`` (2
    microbatches of 4, R1 on one), finite losses and every step's launch
    counts those the path implies, every launch on the tensor cores; an
    fp32 accumulated d_step with R1 through the kernels against
    ``plain_reference()``; (b) the fp32 R1 penalty with ``gp_chunk=4`` at
    b = 8 and every D gradient against the unchunked step (no flips: the
    chunked penalty runs on the un-augmented pipeline); (c) fp32 d_step+R1
    and g_step gradients with ``remat`` and D's ``remat_stages`` against
    none, same seed (REMAT_TOL); then the peak device memory of d_step+R1
    at microbatch 16 unchunked, with ``gp_chunk=8``, with
    ``remat_stages`` and with both recomputations, and of the g_step with
    and without (launch counts checked; the chunked peak must be lower);
    (d) ``train(24)`` with ``log_steps_every=8`` and a ``log_hook`` (JAX's
    record keys), both sample grids under ``chiprun_out/samples``, then
    ``save``, ``load`` into two fresh trainers (state equal), and one more
    iteration of each from the restored RNG (the continued and the resumed
    trainer within 3 times the distance of the two resumed copies, the
    card's own noise in the default mode, where cuDNN may pick algorithms
    that sum in any order); then the same resume in a child process
    (``--deterministic-resume``, run beside phase 11) under
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
    cores; ``generate(texts=...)`` at batch 1 and 8 (launch counts); fp32
    d_steps (matching rows folded in; R1 in both forms) and a g_step
    against ``plain_reference()`` with its attention in float64 (losses
    and every D, VD or G gradient, 0.02); K1 and K2 at every shape and
    dtype the run and the sampling gave them (recorded at their
    dispatchers) against their plain versions, as called and in fp32, on
    the routes their rules name;
14. the UNet upsampler recipe of examples/train_upsampler.py at full
    width (64 -> 256, dim 32, five stages, 47.89M-parameter G; its D reads
    G's rgbs at 128; batch 8, bf16, ``MockImageDataset(256, seed=0)``): 8
    iterations with R1 on 0 and 4, then 2 with R1 forward-over-reverse,
    every loss finite and every step's K1-K7b launch counts those
    ``expected_upsampler_launches`` derives from the configuration (the
    linear-attention kernel once per linear attention in each d_step's
    fakes, never in a g_step), every bf16 launch on the tensor cores;
    ``generate(lowres)`` at batch 1 and 8 (46 K1, 5 K3 and 6
    linear-attention calls per forward) and a batch-1 256 -> 1024 request
    with the same widths (launch counts); fp32 d_steps with R1 in both
    forms and a g_step against ``plain_reference()`` with float64
    attention (0.02); a
    video forward (4 frames, fp32, four stages) against the plain path,
    its 65536-row temporal attention split at K3's grid limit; K3, K4 and
    K5 at a batch of 65536 + 8 against their plain versions, two launches
    each; K1 and K2 at every shape and dtype of the run and the sampling
    against their plain versions; K3/K4 at G's attention shapes and K3 at
    the 1024 request's 16384 tokens; the linear-attention kernel at the
    1024 request's six calls (65,536-1,048,576 tokens) against a float64
    evaluation, at most LINATTN_FROM_F64_RATIO times as far as the plain
    bf16 form;
16. the outer surface at the quickstart's full width: (a) the command
    line, each command the package's ``__main__`` (what ``python -m
    gigagan_tpu_torch`` runs) in a child process that reports its kernel
    launches at exit: ``train --mock-data --steps 8 --batch-size 8
    --save-every 4``, ``train --resume --steps 2`` (2 more iterations),
    ``generate --num 16``, ``evaluate --mock-data --num 64 --batch 8``
    (CLIP-FID on random-init CLIP, which it must say), ``train-upsampler
    --mock-data --steps 4 --batch-size 4`` and ``upsample`` of a 64² PNG
    the port wrote; each output exists, has its shape and is finite, and
    every bf16 launch is on the tensor cores; (b) the model folder the JAX
    package's CLI wrote (``tests/torch_fixtures/jax_model``, flax msgpack)
    and the same state saved by its trainer as an orbax directory
    (``jax_model_orbax``: OCDBT, zarr v2, zstd, read through the
    hand-written host decoder): ``generate`` runs from each, their G and
    G_ema, in fp32 through the kernels, give the recorded JAX outputs
    within 0.02, and the two folders' G and G_ema are bitwise equal; (c)
    data parallel on the one card: 2 ranks as child processes on
    ``cuda:0`` over gloo, the fp32 d_step with R1 and g_step of the
    quickstart pair at global batch 2 × 4 against one process at batch 8
    (losses within 1e-4 relative; every all-reduced gradient within 1e-4
    × max |want| of its leaf from the same 2 × 4 split taken in one
    process, and within 1e-3 of one process at batch 8, or as far as that
    split in one process sits from it plus 1e-4, at most 1e-2), then 4
    bf16 iterations (R1 on the first): finite losses, every K1-K5 launch
    on the tensor cores, the parameters bitwise equal across the ranks
    after every step (checksums compared on rank 0); one process over NCCL
    (world size 1) takes the same 4 iterations at batch 8;

and, last, the device line.  Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import gc
import json
import math
import os
import pathlib
import re
import shutil
import socket
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from gigagan_tpu_torch import GigaGAN, OpenClipAdapter, ops, parallel
from gigagan_tpu_torch import cli as port_cli
from gigagan_tpu_torch.data import (
    MockImageDataset,
    MockTextImageDataset,
    SyntheticShapesDataset,
    cycle,
)
from gigagan_tpu_torch.models.layers import AdaptiveConv, init_parameters
from gigagan_tpu_torch.models.unet_upsampler import (
    Attention2D,
    LinearAttention2D,
    UnetUpsampler,
)
from gigagan_tpu_torch.ops import attention as ops_attention
from gigagan_tpu_torch.ops.kernels import adaptive_conv as k1
from gigagan_tpu_torch.ops.kernels import build, plain_reference
from gigagan_tpu_torch.ops.kernels import demod as kdemod
from gigagan_tpu_torch.ops.kernels import flash_attention as k6
from gigagan_tpu_torch.ops.kernels import flash_attention_fused as k3
from gigagan_tpu_torch.ops.kernels import flash_attention_hv as k7
from gigagan_tpu_torch.ops.kernels import flash_attention_so as so
from gigagan_tpu_torch.ops.kernels import linear_attention as klinattn
from gigagan_tpu_torch.parallel import dist
from gigagan_tpu_torch.train import sample_graph
from gigagan_tpu_torch.train.steps import StepDraws
from gigagan_tpu_torch.utils.png import decode_png, encode_png

REPO = pathlib.Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"
BF16 = torch.bfloat16

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
           ("masked dot d80", 1, 3, 260, 131, 80, False, True),
           ("phi d128", 64, 4, 1024, 1025, 128, True, False),
           ("phi d128", 128, 4, 256, 257, 128, True, False)]
# rows held in bf16 only (fp32 at d = 128 runs the CUDA-core kernels, which
# the small d128 row holds)
HV_BF16_ONLY = ("phi d128",)
# phase 17's discriminator: the quickstart D with 4 heads of 128 (the same
# b·H·n²·d as 8 heads of 64), and its R1 attention shapes for K5 (who, b,
# heads, tokens, L2 similarity?), those of the d_step's [real; fake] batch
# grown by the multiscale groups as R1_ATTN
D128_HEADS, D128_DIM_HEAD = 4, 128
QUICKSTART_D128 = dict(QUICKSTART_D, attn_heads=D128_HEADS,
                       attn_dim_head=D128_DIM_HEAD)
R1_ATTN_D128 = [("D128 d_step", 64, D128_HEADS, 1024, True),
                ("D128 d_step", 128, D128_HEADS, 256, True)]
# K6a/K6b where sample 0 has every key masked (NEG_INF in its whole bias
# row): the plain version gives the mean of v, lse = NEG_INF and, from that
# lse, P = 1 at every key; both routes must give it, finite
K6_ALL_MASKED = [("all masked", 2, 2, 300, 200, DIM_HEAD, False, "all"),
                 ("all masked d128", 2, 2, 300, 200, 128, False, "all")]
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
KERNEL_NAMES = ("k1", "k2", "k3", "k4", "k5", "k6a", "k6b", "k7a", "k7b",
                "demod", "linattn")
# the linear-attention kernel's distance from a float64 evaluation on the
# same bf16 operands may be at most this many times the plain bf16 form's:
# both round the normalised q, the context and out to bf16 (the kernel
# exp(k − m) where the plain form rounds exp(k − m) / s, the same relative
# rounding) and sum in another order
LINATTN_FROM_F64_RATIO = 1.25
# phase 16: the JAX-written model folders' G outputs (fp32 conv tolerance);
# the data-parallel fp32 step's losses against one process (relative), and
# its gradients relative to each leaf's max |want|: against the ranks' own
# arithmetic, the batch split DP_WORLD ways and taken in one process
# (DP_SPLIT_TOL), and against one process at the whole batch (DP_GRAD_TOL).
# Splitting the batch reorders every sum over it, and some leaves are sums
# that cancel to a small fraction of their terms (G's pixel-noise weights
# contract the upstream gradient with N(0, 1) noise over every pixel; D's
# deepest stage under R1): on an H100 the split read up to 3.7e-3 from the
# whole batch on 38 of 237 leaves, taken by 2 ranks or in one process
# alike, while the ranks read 5.1e-6 from the same split in one process and
# a repeated 1-process step 6.3e-6 from itself.  So a leaf may sit as far
# from one process as the split in one process does, plus DP_SPLIT_TOL,
# and never past DP_GRAD_CAP (half the fp32 whole-model gate of 0.02); a
# missing all-reduce, a wrong scale or wrong draws move leaves by O(1)
JAX_FOLDER_TOL, DP_LOSS_TOL = 0.02, 1e-4
DP_SPLIT_TOL, DP_GRAD_TOL, DP_GRAD_CAP = 1e-4, 1e-3, 1e-2
DP_WORLD, DP_ITERATIONS, CLI_TIMEOUT_S = 2, 4, 600


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


def max_rel(got, want):
    """The largest ``rel_err`` over paired outputs, pairs whose wanted
    output is None left out."""
    return max(rel_err(a_, w_) for a_, w_ in zip(got, want) if w_ is not None)


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


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


def attention_counts(gan):
    """(G's self-attentions, D's attentions) of a G+D trainer."""
    return (sum(st.self_attn is not None for st in gan.G.stages),
            sum(st.core.attn is not None for st in gan.D.stages))


def t2i_structure(gan):
    """(adaptive convs in D's predictors, adaptive convs in the
    vision-aided D) of a text-to-image trainer."""
    return (sum(isinstance(m, AdaptiveConv) for st in gan.D.stages
                if st.predictor is not None for m in st.predictor.modules()),
            sum(isinstance(m, AdaptiveConv) for m in gan.VD.modules()))


def expected_step_launches(n_convs, n_g_attn, n_d_attn, accum=1, chunks=0,
                           remat=False, remat_stages=False):
    """Launches per step the training path implies.  d_step: G forward
    without gradient (K1 per conv, K3 per G attention, the demodulation
    kernel per conv: every G conv is demodulated), D's attention
    forward (K3) and backward (K4); with R1, K4 once more for the penalty's
    input gradient, and then either K5 in the double backward
    (reverse-over-reverse) or, forward-over-reverse, per D attention in
    the surrogate φ: K6a (its forward on split heads), K7a (its jvp), and
    in the backward K7b (through the tangent) and K6b (through the primal,
    which later layers' tangents read).  g_step: G forward and backward (K1
    forward and as dx, K2 per conv; the demodulation on the differentiable
    chain), G's and D's attention forward and backward.

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
    none = dict(k5=0, k6a=0, k6b=0, k7a=0, k7b=0, demod=0, linattn=0)
    d = dict(none, k1=n_convs, k2=0, k3=n_g_attn + (1 + r + s) * n_d_attn,
             k4=n_d_attn, demod=n_convs)
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
    more per microbatch.  The demodulation kernel runs in G's forwards
    without gradient alone (the d_step's fakes, the pool's pass): D's and
    the VD's convs are differentiated in every step."""
    none = dict(k5=0, k6a=0, k6b=0, k7a=0, k7b=0, demod=0, linattn=0)
    d = dict(none, k1=n_g + 2 * n_p + 4 * n_v, k2=n_p + 2 * n_v,
             k3=n_ga + n_da, k4=n_da, demod=n_g)
    d_r1 = dict(d, k1=n_g + 4 * n_p + 6 * n_v, k2=3 * n_p + 4 * n_v,
                k3=n_ga + 2 * n_da, k4=3 * n_da, k5=n_da)
    d_for = dict(d, k1=n_g + 3 * n_p + 6 * n_v, k2=2 * n_p + 4 * n_v,
                 k3=n_ga + 2 * n_da, k4=3 * n_da, k6a=n_da, k6b=n_da,
                 k7a=n_da, k7b=n_da)
    pool = int(accum > 1)
    g = dict(none, k1=(2 + pool) * n_g + 2 * n_p + 2 * n_v,
             k2=n_g + n_p + n_v, k3=(1 + pool) * n_ga + n_da,
             k4=n_ga + n_da, demod=pool * n_g)
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


def upsampler_linear_attentions(cfg):
    """The linear-attention layers of a UnetUpsampler config's image
    forward: those of the down and up stages not marked in
    ``full_attn``."""
    mults = cfg.get("dim_mults", (1, 2, 4, 8, 16))
    full = cfg.get("full_attn", (False, False, False, True, True))
    depths = cfg.get("attn_depths", (1,) * len(mults))
    return 2 * sum(d_ for f_, d_ in zip(full, depths) if not f_)


def expected_upsampler_launches(cfg, n_d_attn):
    """Launches per step of the upsampler's training path: the
    quickstart's structure (``expected_step_launches``) for the adaptive
    convs and full attentions ``upsampler_structure`` counts in G (K1 per
    conv in the d_step's no-grad forward; forward, dx and K2 in the
    g_step; K3/K4 per attention, no null token) and D's ``n_d_attn``; the
    linear-attention kernel once per linear attention of G in the d_step's
    no-grad forward (the g_step differentiates them: the plain form)."""
    n_convs, n_g_attn = upsampler_structure(cfg)
    n_linear = upsampler_linear_attentions(cfg)
    d, d_r1, d_for, g = expected_step_launches(n_convs, n_g_attn, n_d_attn)
    return tuple(dict(row, linattn=n_linear)
                 for row in (d, d_r1, d_for)) + (g,)


# where each kernel's entries live, as module attributes ``<base>_tc`` and
# ``<base>_simt`` that its dispatcher reads
ENTRY_HOME = {"k1": (k1, "adaptive_conv_fwd"),
              "k2": (k1, "adaptive_conv_bwd_w"),
              "k3": (k3, "flash_attention_fused_fwd"),
              "k4": (so, "flash_attention_fused_bwd"),
              "k5": (so, "flash_attention_so_bwd2"),
              "k6a": (k6, "flash_attention_fwd"),
              "k6b": (k6, "flash_attention_bwd"),
              "k7a": (k7, "flash_attention_hv_jvp"),
              "k7b": (k7, "flash_attention_hv_bwd")}


# kernels with one implementation (so outside the checks of the tensor-core
# and CUDA-core routes): the demodulation, fp32 on the CUDA cores whatever
# the model's dtype, and the linear attention, bf16 alone: the entry that
# counts its launches
ONE_ROUTE = {"demod": kdemod.demod_scale_cuda,
             "linattn": klinattn.linear_attend_cuda}


def kernel_entries():
    """{kernel: (tensor-core entry, CUDA-core entry)} of the kernels with
    two routes: each entry counts its own launches (``.launches``)."""
    return {k: (getattr(mod, f"{base}_tc"), getattr(mod, f"{base}_simt"))
            for k, (mod, base) in ENTRY_HOME.items()}


def launch_counts(reset=False):
    """This process's launches per kernel and route (``cuda`` for the
    kernels of ONE_ROUTE); ``reset`` zeroes them after reading."""
    out = {}
    for k, (tc, simt) in kernel_entries().items():
        out[k] = {"tc": tc.launches, "simt": simt.launches}
        if reset:
            tc.launches = simt.launches = 0
    for k, entry in ONE_ROUTE.items():
        out[k] = {"cuda": entry.launches}
        if reset:
            entry.launches = 0
    return out


def routes_line(counts):
    """``launch_counts()`` as one log line: tc/simt launches, or the one
    route's."""
    return ", ".join(f"{k} " + "/".join(str(n_) for n_ in v.values())
                     for k, v in counts.items() if any(v.values())) + \
        " (tc/simt)"


def on_cuda_cores(counts):
    """The kernels of ``launch_counts()`` with launches on their CUDA-core
    route."""
    return [k for k, v in counts.items() if v.get("simt")]


class Ctx:
    """What the phases share: the device ``dev`` (``dev.type`` is what the
    trainers are built on), the seeded generator ``gen`` of the kernel
    phases' random operands, the nvidia-smi line, the report written to
    ``chiprun_out/chip_smoke.json``, and the launch counters of K1-K7b, the
    demodulation and the linear-attention kernels: every kernel counts the
    launches of its implementations, and K1-K7b's CUDA-core ones alone are
    read as well, to show that no bf16 call reached them."""

    def __init__(self, dev, smi):
        self.dev, self.smi = dev, smi
        self.gen = torch.Generator(device=dev).manual_seed(0)
        self.report = {"gpu": smi, "phase_seconds": {}}
        entries = kernel_entries()
        self.tc = {k_: e[0] for k_, e in entries.items()}
        self.simt = {k_: e[1] for k_, e in entries.items()}
        self._mark = time.perf_counter()

    def phase_done(self, label):
        """Log and record the seconds since the last phase ended."""
        now = time.perf_counter()
        seconds = self.report["phase_seconds"][label] = now - self._mark
        self._mark = now
        log(f"phase {label}: {seconds:.1f} s")

    def reset_counts(self):
        launch_counts(reset=True)

    def read_counts(self):
        return {k_: sum(v.values()) for k_, v in launch_counts().items()}

    def simt_counts(self):
        return {k_: fn.launches for k_, fn in self.simt.items()}

    @contextlib.contextmanager
    def simt_kernels(self, keys):
        """The kernels `keys` on their CUDA-core implementations for every
        dtype: the dispatch patched here, not through a switch of the
        package."""
        for k_ in keys:
            mod, base = ENTRY_HOME[k_]
            setattr(mod, f"{base}_tc", self.simt[k_])
        try:
            yield
        finally:
            for k_ in keys:
                mod, base = ENTRY_HOME[k_]
                setattr(mod, f"{base}_tc", self.tc[k_])

    def launches(self, kname, call):
        """call() and the launches of kernel `kname` it made per route."""
        routes = (("tc", self.tc), ("simt", self.simt))
        before = {r: e[kname].launches for r, e in routes}
        res = call()
        return res, {r: e[kname].launches - before[r] for r, e in routes}

    def launched_on(self, kname, call):
        """call() and the route of the kernel it launched on (None if it
        did not launch exactly once, on one route)."""
        res, ran = self.launches(kname, call)
        hit = [r for r, n_ in ran.items() if n_]
        return res, (hit[0] if len(hit) == 1 and ran[hit[0]] == 1
                     else None)

    def route_of(self, kname, call):
        """call() and the one route all its launches took (None if it
        launched nothing or on both)."""
        res, ran = self.launches(kname, call)
        hit = [r for r, n_ in ran.items() if n_]
        return res, (hit[0] if len(hit) == 1 else None)


# ------------------------------------------------------- child processes

def cli_child(counts_path, argv):
    """Phase 16(a)'s child: the package's ``__main__`` with ``argv``, as
    ``python -m gigagan_tpu_torch`` runs it, and at exit this process's
    kernel launches written to ``counts_path``."""
    import runpy

    atexit.register(lambda: pathlib.Path(counts_path).write_text(
        json.dumps(launch_counts())))
    sys.argv = ["gigagan_tpu_torch", *argv]
    runpy.run_module("gigagan_tpu_torch", run_name="__main__",
                     alter_sys=True)


def fp32_steps(g_cfg, d_cfg, batch, device, shards=1):
    """An fp32 d_step with R1 and a g_step of the pair, each from the
    fresh state of seed 0: (d losses, D gradients, g losses, G
    gradients), the gradients as the optimizers stepped with them.  With
    ``shards`` = k, the data-parallel arithmetic of k ranks in this one
    process: each step taken k times from the fresh state, on each k-th of
    the batch with that rank's slice of the global draws, and the losses
    and gradients averaged (summed in rank order, then divided)."""
    b = batch.shape[0] // shards
    out = []
    for step in ("d", "g"):
        losses, grads = {}, {}
        for r in range(shards):
            gan = GigaGAN(generator=g_cfg, discriminator=d_cfg, amp=False,
                          seed=0, device=device)
            with dist.global_batch_draws(r, shards):
                if step == "d":
                    got = gan.train_discriminator_step(
                        batch[r * b:(r + 1) * b], apply_gradient_penalty=True,
                        calc_multiscale_loss=True, seed=11)
                else:
                    got = gan.train_generator_step(
                        b, calc_multiscale_loss=True, seed=12)
            module = gan.D if step == "d" else gan.G
            for n, p in module.named_parameters():
                if p.grad is not None:
                    grads[n] = grads[n] + p.grad if n in grads else p.grad
            for k, v in got.items():
                losses[k] = losses.get(k, 0.0) + float(v)
            del gan
        out += [{k: v / shards for k, v in losses.items()},
                {n: (g / shards).cpu() for n, g in grads.items()}]
    return out


def dp_child(spec):
    """Phase 16(c)'s child: rank ``spec["rank"]`` of ``spec["world"]`` over
    ``spec["backend"]`` on ``cuda:0``.  fp32 (``"fp32" in modes``): a
    d_step with R1 and a g_step of the quickstart pair on this rank's slice
    of the batch-8 pool, rank 0 saving the losses and the all-reduced
    gradients; bf16: ``DP_ITERATIONS`` iterations (R1 on the first), the
    parameters' checksums compared on rank 0 after every step.  Rank 0
    writes ``spec["out"]``: launches per mode, losses, which steps left the
    ranks' parameters unequal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = spec["rank"], spec["world"]
    parallel.init(spec["backend"], f"tcp://127.0.0.1:{spec['port']}", world,
                  rank)
    data = MockImageDataset(256, length=BATCH, seed=0)
    b = BATCH // world
    mine = np.stack([data[i] for i in range(rank * b, (rank + 1) * b)])
    out = {"rank": rank, "world": world, "backend": spec["backend"]}
    launch_counts(reset=True)
    if "fp32" in spec["modes"]:
        # each step from the fresh state (after a d_step, Adam's first
        # update moves every weight by ±lr by its gradient's sign, which
        # the order of the sums decides where a gradient is near 0)
        d, d_grads, g, g_grads = fp32_steps(QUICKSTART, QUICKSTART_D, mine,
                                            "cuda:0")
        if rank == 0:
            torch.save({"d": {k: float(v) for k, v in d.items()},
                        "g": {k: float(v) for k, v in g.items()},
                        "D": d_grads, "G": g_grads}, spec["fp32_out"])
        out["launches_fp32"] = launch_counts(reset=True)
        del d_grads, g_grads
        torch.cuda.empty_cache()
    if "bf16" in spec["modes"]:
        gan = GigaGAN(generator=QUICKSTART, discriminator=QUICKSTART_D,
                      amp=True, seed=0, device="cuda:0")
        modules = (gan.G, gan.G_ema, gan.D)
        unequal, losses = [], []
        for it in range(DP_ITERATIONS):
            d = gan.train_discriminator_step(
                mine, apply_gradient_penalty=it % R1_EVERY == 0,
                calc_multiscale_loss=True)
            sums = [parallel.checksum([p for m in modules
                                       for p in m.parameters()])]
            g = gan.train_generator_step(b, calc_multiscale_loss=True)
            sums.append(parallel.checksum([p for m in modules
                                           for p in m.parameters()]))
            for step, local in zip(("d", "g"), sums):
                every = parallel.all_gather_cat(local[None])
                if not all(torch.equal(every[0], row) for row in every):
                    unequal.append(f"iteration {it} {step}_step")
            losses.append({**{f"d_{k}": float(v) for k, v in d.items()},
                           **{f"g_{k}": float(v) for k, v in g.items()}})
        out.update(losses=losses, unequal=unequal,
                   launches_bf16=launch_counts(reset=True))
    torch.cuda.synchronize()
    parallel.barrier()
    if rank == 0:
        pathlib.Path(spec["out"]).write_text(json.dumps(out))
    torch.distributed.destroy_process_group()
    return 0


def deterministic_resume():
    """Phase 12(d)'s resume under ``torch.use_deterministic_algorithms``,
    run as a child process (``--deterministic-resume``) whose parent set
    ``CUBLAS_WORKSPACE_CONFIG`` before CUDA started: the quickstart pair
    takes 2 iterations (R1 on the second), is saved and loaded into two
    fresh trainers, and all three take one more iteration with R1; their
    parameters and optimizer states must be bitwise equal.  Then two fresh
    upsampler trainers of the recipe take a d_step with R1 and a g_step
    from one seed (bitwise equal); for phase 17, two fresh pairs with the
    d = 128 discriminator take a d_step with R1 in each form from one seed
    (D's gradients bitwise equal, every K5/K7a/K7b launch on the tensor
    cores); and a small video upsampler's forward and backward run once
    (what the mode refuses there is reported).
    Prints one ``DETERMINISTIC {json}`` line; exits 1 when something
    differs or is refused."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

        # the d = 128 discriminator's R1 through the tensor-core K5 and
        # K7a/K7b, which sum without float atomics
        out["d128_differs"], out["d128_launches"] = {}, {}
        for form, for_ in (("reverse-over-reverse", False),
                           ("forward-over-reverse", True)):
            grads = []
            launch_counts(reset=True)
            for _ in range(2):
                pair = GigaGAN(generator=QUICKSTART,
                               discriminator=QUICKSTART_D128, amp=True,
                               seed=0, device="cuda", gp_fwd_over_rev=for_)
                pair.train_discriminator_step(
                    pool, apply_gradient_penalty=True,
                    calc_multiscale_loss=True, seed=3)
                grads.append({n_: p_.grad.detach().clone()
                              for n_, p_ in pair.D.named_parameters()})
                del pair
            torch.cuda.synchronize()
            counts = launch_counts(reset=True)
            out["d128_launches"][form] = counts
            out["d128_differs"][form] = [
                n_ for n_, g_ in grads[0].items()
                if not torch.equal(g_, grads[1][n_])]
            ran = ("k7a", "k7b") if for_ else ("k5",)
            if any(counts[k_]["simt"] or not counts[k_]["tc"] for k_ in ran):
                out["d128_differs"][form].append(
                    f"launches off the tensor cores: {counts}")
            del grads
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
        out["resume_differs"].values()) and not out["upsampler_differs"] \
        and not any(out["d128_differs"].values())
    out["ok"] = ok
    print("DETERMINISTIC " + json.dumps(out), flush=True)
    return 0 if ok else 1


# ------------------------------------------------- phases 1-8: the kernels

def phase_1_card():
    """The card: fails without CUDA; logs its name and power limit, turns
    TF32 off.  Returns the Ctx of the later phases."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAIL: torch.cuda.is_available() is "
                         "false — this check runs on a CUDA device only")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    return Ctx(torch.device("cuda", 0), smi)


def phase_2_build(ctx):
    """Every kernel built (their ptxas reports to chiprun_out/ptxas.log)
    and loaded; the tensor-core libraries' SASS holds HGMMA and UTMALDG."""
    built = build.build_all(verbose=True)
    log(f"build: {len(built)} kernels (one nvcc each, in parallel)")
    (OUT_DIR / "ptxas.log").write_text("\n".join(
        f"== {kname}\n{text}" for kname, (_, text, _) in built.items()))
    for kname, (_, text, _) in built.items():
        build.load(kname)
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        log(f"  ptxas {kname}: {len(regs)} kernels, at most {max(regs)} "
            f"registers and {max(spills, default=0)} bytes of spill stores "
            "(details in chiprun_out/ptxas.log)")
    # a tensor-core kernel that quietly lost its tensor cores or its TMA
    # loads fails here
    cuobjdump = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    ctx.report["sass"] = {}
    tc_libs = ("adaptive_conv_fwd_tc", "adaptive_conv_bwd_w_tc",
               "flash_attention_fused_fwd_tc", "flash_attention_fused_bwd_tc",
               "flash_attention_so_bwd2_tc", "flash_attention_hv_jvp_tc",
               "flash_attention_hv_bwd_tc")
    with concurrent.futures.ThreadPoolExecutor(len(tc_libs)) as pool_:
        dumps = dict(zip(tc_libs, pool_.map(
            lambda k_: subprocess.run(
                [str(cuobjdump), "-sass", str(built[k_][0])],
                capture_output=True, text=True, check=True).stdout,
            tc_libs)))
    for kname, sass in dumps.items():
        found = {op: len(re.findall(rf"\b{op}\b", sass))
                 for op in ("HGMMA", "UTMALDG")}
        ctx.report["sass"][kname] = found
        log(f"  sass {kname}: {found}")
        if not all(found.values()):
            fail(f"{kname} lacks tensor-core products or TMA loads: {found}")
    # the linear attention's products on the tensor cores by mma.sync
    # (HMMA), fed by ldmatrix (LDSM) from cp.async (LDGSTS) rings
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(built["linear_attention"][0])],
        capture_output=True, text=True, check=True).stdout
    found = {op: len(re.findall(rf"\b{op}\b", sass))
             for op in ("HMMA", "LDSM", "LDGSTS")}
    ctx.report["sass"]["linear_attention"] = found
    log(f"  sass linear_attention: {found}")
    if not all(found.values()):
        fail(f"linear_attention lacks tensor-core products or its "
             f"asynchronous loads: {found}")
    # K5's, K7a's and K7b's kernels one by one: each instantiation, those
    # at d = 128 (template argument 2) among them, holds both
    for kname in tc_libs[4:]:
        per = {}
        for body in re.split(r"Function : ", dumps[kname])[1:]:
            fname = body.split(None, 1)[0]
            if "_tc_kernel" in fname:
                per[fname] = {op: len(re.findall(rf"\b{op}\b", body))
                              for op in ("HGMMA", "UTMALDG")}
        n128 = sum("ILi2E" in f_ for f_ in per)
        ctx.report["sass"][kname + "_kernels"] = per
        if not n128 or not all(all(v.values()) for v in per.values()):
            fail(f"a {kname} kernel lacks tensor-core products or TMA "
                 f"loads, or none is built for d = 128: {per}")
        log(f"  sass {kname}: {len(per)} kernels ({n128} at d = 128), "
            f"fewest HGMMA {min(v['HGMMA'] for v in per.values())} and "
            f"UTMALDG {min(v['UTMALDG'] for v in per.values())} in one")


def conv_operands(ctx, b, h, w_, ci, co, n):
    """x_mod, banks, selection weights and demod as the generator's
    AdaptiveConv hands them to K1."""
    dev, gen = ctx.dev, ctx.gen
    x = torch.randn(b, h, w_, ci, device=dev, generator=gen)
    w = torch.randn(n, 3, 3, ci, co, device=dev, generator=gen) * (
        2.0 / (9 * ci)) ** 0.5
    a = torch.softmax(torch.randn(b, n, device=dev, generator=gen), -1)
    scale_in = 1.0 + 0.2 * torch.randn(b, ci, device=dev, generator=gen)
    d = ops.demod_scale(w, scale_in, a)
    return x * scale_in[:, None, None, :], w, a, d


def phase_3_k1(ctx):
    """K1 at the generator's conv shapes and at the extra rows.  Returns
    the (h, ci, co) it held, which phase 5 holds the sampling path to."""
    rows = {}
    for _, h, ci, co in path_convs(QUICKSTART):
        if (h, ci, co) in rows:
            continue
        xm, w, a, d = conv_operands(ctx, BATCH, h, h, ci, co, 2)
        want = k1.adaptive_conv_fwd_plain(xm, w, a, d)
        got32 = k1.adaptive_conv_fwd(xm, w, a, d)
        xb, wb = xm.bfloat16(), w.bfloat16()
        got16 = k1.adaptive_conv_fwd(xb, w, a, d)
        got16w = k1.adaptive_conv_fwd(xb, wb, a, d)
        torch.cuda.synchronize()
        row = dict(
            h=h, ci=ci, co=co,
            route_bf16="tc" if k1.conv_uses_tensor_cores(BF16, ci, co)
            else "simt",
            rel_f32=rel_err(got32, want), rel_bf16=rel_err(got16, want),
            rel_bf16_banks=rel_err(got16w, want))
        rows[(h, ci, co)] = row
        log(f"K1 b{BATCH} {h}x{h} {ci}->{co}: rel f32 {row['rel_f32']:.2e} "
            f"bf16 ({row['route_bf16']}) {row['rel_bf16']:.2e}, bf16 banks "
            f"{row['rel_bf16_banks']:.2e}")
        if not (row["rel_f32"] <= K1_TOL_F32
                and max(row["rel_bf16"], row["rel_bf16_banks"])
                <= K1_TOL_BF16):
            fail(f"K1 disagrees at {row}")
    if any(r["route_bf16"] != "tc" for r in rows.values()):
        fail("a path conv shape is not on the tensor-core K1")
    ctx.report["k1"] = list(rows.values())
    # extra rows: a ragged map with co not a multiple of 32 (16-wide co
    # tiles), one bank, and the four banks of the conv pair's double
    # backward; bf16 with fp32 and bf16 banks on the tensor cores
    extra = []
    for b, h, w_, ci, co, n in K1_EXTRA:
        xm, w, a, d = conv_operands(ctx, b, h, w_, ci, co, n)
        want = k1.adaptive_conv_fwd_plain(xm, w, a, d)
        xb = xm.bfloat16()
        before = ctx.tc["k1"].launches
        got = [k1.adaptive_conv_fwd(xb, w, a, d),
               k1.adaptive_conv_fwd(xb, w.bfloat16(), a, d)]
        torch.cuda.synchronize()
        row = dict(b=b, h=h, w=w_, ci=ci, co=co, n=n,
                   rel=max(rel_err(g_, want) for g_ in got),
                   tc=ctx.tc["k1"].launches - before == 2)
        extra.append(row)
        log(f"K1 extra b{b} {h}x{w_} {ci}->{co} n={n} bf16 (tc "
            f"{row['tc']}): rel {row['rel']:.2e}")
        if not (row["tc"] and row["rel"] <= K1_TOL_BF16):
            fail(f"K1 extra row failed: {row}")
    ctx.report["k1_extra"] = extra
    return set(rows)


def attn_operands(ctx, b, heads, nq, nk, d, l2, null, dtype):
    """K3's prepared operands from random q, k, v and null_kv."""
    dev, gen = ctx.dev, ctx.gen
    q = torch.randn(b, nq, heads * d, device=dev, generator=gen).to(dtype)
    k, v = (torch.randn(b, nk, heads * d, device=dev,
                        generator=gen).to(dtype) for _ in range(2))
    null_kv = (torch.randn(2, heads, d, device=dev, generator=gen)
               if null else None)
    k_pre, bias, nullk, nullv, null_bias = k3.prep_fused(
        k, v, null_kv, heads, l2, d ** -0.5)
    return q, k_pre, v, bias, nullk, nullv, null_bias, heads


def attn_rows(path_shapes):
    """(who, b, heads, nq, nk, d, l2, null, dtype) of the attention
    phases: the path shapes, then the small rows."""
    for who, b, n, l2 in path_shapes:
        for dtype in (torch.float32, BF16):
            yield who, b, HEADS, n, n, DIM_HEAD, l2, True, dtype
    for who, b, h, nq, nk, d in ATTN_SMALL:
        for null in (True, False):
            for l2 in (False, True):
                for dtype in (torch.float32, BF16):
                    yield who, b, h, nq, nk, d, l2, null, dtype


def phase_4_k3(ctx):
    """K3 at the training path's attention shapes and the small rows."""
    rows = []
    for who, b, h, nq, nk, d, l2, null, dtype in attn_rows(ATTN_PATH):
        args = attn_operands(ctx, b, h, nq, nk, d, l2, null, dtype)
        o_want, l_want = k3.flash_attention_fused_fwd_plain(*args)
        o_got, l_got = k3.flash_attention_fused_fwd(*args)
        torch.cuda.synchronize()
        row = dict(
            who=who, b=b, heads=h, nq=nq, nk=nk, d=d, l2=l2, null=null,
            dtype=dtype_name(dtype),
            route="tc" if k3.uses_tensor_cores(dtype, d) else "simt",
            rel_out=rel_err(o_got, o_want), rel_lse=rel_err(l_got, l_want))
        rows.append(row)
        log(f"K3 {who} b{b} H{h} nq{nq} nk{nk} d{d} l2={l2} null={null} "
            f"{row['dtype']} ({row['route']}): rel out {row['rel_out']:.2e} "
            f"lse {row['rel_lse']:.2e}")
        if not (row["rel_out"] <= K3_TOL and row["rel_lse"] <= K3_TOL):
            fail(f"K3 disagrees at {row}")
        del args, o_want, o_got, l_want, l_got
    torch.cuda.empty_cache()
    ctx.report["k3"] = rows


def phase_5_sampling(ctx, k1_shapes):
    """The quickstart G's sampling path: launch counts of the eager call
    and the graph's capture per batch size, the graphs held, the conv
    shapes those phase 3 held, and an fp32 forward against the plain
    path."""
    gan = GigaGAN(generator=QUICKSTART, amp=True, device=ctx.dev.type,
                  seed=0)
    seen = set()
    hooks = [
        m.register_forward_pre_hook(
            lambda mod, args: seen.add(
                (args[0].shape[1], *mod.weights.shape[-2:])))
        for m in gan.G_ema.modules()
        if isinstance(m, AdaptiveConv) and m.weights.shape[1] == 3
    ]

    ctx.reset_counts()
    requests = [BATCH] * 3 + [1] * 3
    for i, bs in enumerate(requests):
        img = gan.generate(batch_size=bs, seed=i)
        size = QUICKSTART["image_size"]
        if img.shape != (bs, size, size, 3) or not np.isfinite(img).all():
            fail(f"request {i} gave {img.shape} / non-finite values")
    counts = ctx.read_counts()
    launches = {k: counts[k] for k in ("k1", "k3", "demod")}
    for hk in hooks:
        hk.remove()
    log(f"sampling path: {len(requests)} requests, launches {counts}")
    # per batch size, the eager first call and the capture issue G's
    # forward from Python; the third call replays the graph.  Every G conv
    # is demodulated, on the kernel: G's forward needs no gradient
    per_forward = {"k1": len(path_convs(QUICKSTART)),
                   "k3": len(SELF_ATTN_RES),
                   "demod": len(path_convs(QUICKSTART))}
    issued = 2 * len(set(requests))
    if launches != {k: n * issued for k, n in per_forward.items()}:
        fail(f"launch counts {launches}")
    held = [e for e in sample_graph.graphs_of(gan.G_ema).entries.values()
            if isinstance(e, sample_graph.Captured)]
    if len(held) != len(set(requests)):
        fail(f"{len(held)} graphs held for batch sizes {set(requests)}")
    if any(n for k, n in counts.items() if k not in per_forward):
        fail(f"backward kernels launched while sampling: {counts}")
    if ctx.simt_counts()["k1"] or ctx.simt_counts()["k3"]:
        fail(f"bf16 sampling reached the CUDA-core K1/K3: "
             f"{ctx.simt_counts()}")
    if seen != k1_shapes:
        fail(f"path conv shapes {seen} != checked {k1_shapes}")
    ctx.report["sampling_launches"] = counts

    gan32 = GigaGAN(generator=QUICKSTART, amp=False, device=ctx.dev.type,
                    seed=0)
    img_k = gan32.generate(batch_size=2, seed=7)
    with plain_reference():
        img_p = gan32.generate(batch_size=2, seed=7)
    g_rel = rel_err(torch.from_numpy(img_k), torch.from_numpy(img_p))
    log(f"G fp32 kernels vs plain path: rel {g_rel:.2e} (tol {G_TOL_F32})")
    ctx.report["g_rel_f32"] = g_rel
    if not g_rel <= G_TOL_F32:
        fail("G forward disagrees")
    del gan, gan32
    torch.cuda.empty_cache()


def phase_18_sample_graph(ctx):
    """The sampler's CUDA graph, the demodulation and the linear-attention
    kernels: the card's tests of tests/test_torch_sample_graph.py,
    tests/test_torch_demod.py and tests/test_torch_linear_attention.py in
    a child pytest."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p",
         "no:cacheprovider", "-m", "cuda", "tests/test_torch_sample_graph.py",
         "tests/test_torch_demod.py", "tests/test_torch_linear_attention.py"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    (OUT_DIR / "sample_graph_tests.log").write_text(proc.stdout + proc.stderr)
    summary = (proc.stdout.strip().splitlines() or [""])[-1]
    ctx.report["sample_graph_tests"] = summary
    log(f"the sampler's graph, the card's tests: {summary}")
    if proc.returncode != 0 or "passed" not in summary or (
            "skipped" in summary):
        fail(f"the sampler's graph tests: {proc.stdout[-3000:]}")


def phase_6_k2(ctx):
    """K2 (and K1 as the input gradient) at the generator's conv shapes,
    K2 at the extra rows and at more banks than one launch takes."""
    dev, gen = ctx.dev, ctx.gen
    rows = {}
    for _, h, ci, co in path_convs(QUICKSTART):
        if (h, ci, co) in rows:
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
        (dw32, da32), route32 = ctx.launched_on(
            "k2", lambda: k1.adaptive_conv_bwd_w(x, g, w, a))
        (dw16, da16), route16 = ctx.launched_on(
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
        before = ctx.tc["k1"].launches
        (dx16,) = torch.autograd.grad(k1.pconv2d(xk16, w, a, d), xk16, gb)
        torch.cuda.synchronize()
        if ctx.tc["k1"].launches - before != 2:
            fail(f"bf16 K1 forward and dx at {h}x{h} {ci}->{co} did not both "
                 "run on the tensor-core kernel")
        row = dict(
            h=h, ci=ci, co=co,
            rel_dw_f32=rel_err(dw32, dw_want),
            rel_da_f32=rel_err(da32, da_want),
            rel_dw_bf16=rel_err(dw16, dw_want),
            rel_da_bf16=rel_err(da16, da_want),
            rel_dw_same=rel_err(dw16, dw_same),
            rel_da_same=rel_err(da16, da_same),
            rel_dx_f32=rel_err(dx32, dx_want),
            rel_dx_bf16=rel_err(dx16, dx_want))
        rows[(h, ci, co)] = row
        log(f"K2 b{BATCH} {h}x{h} {ci}->{co}: rel dW/da f32 "
            f"{row['rel_dw_f32']:.2e}/{row['rel_da_f32']:.2e} bf16 "
            f"{row['rel_dw_bf16']:.2e}/{row['rel_da_bf16']:.2e} (same "
            f"inputs {row['rel_dw_same']:.2e}/{row['rel_da_same']:.2e}) | "
            f"K1-dx rel f32 {row['rel_dx_f32']:.2e} bf16 "
            f"{row['rel_dx_bf16']:.2e}")
        if not (max(row["rel_dw_f32"], row["rel_da_f32"],
                    row["rel_dx_f32"]) <= K2_TOL_F32
                and max(row["rel_dw_bf16"], row["rel_da_bf16"],
                        row["rel_dx_bf16"]) <= K2_TOL_BF16
                and max(row["rel_dw_same"],
                        row["rel_da_same"]) <= K2_TOL_SAME):
            fail(f"K2 / K1-as-dx disagrees at {row}")
    ctx.report["k2"] = list(rows.values())
    # extra rows for the tensor-core route's edges: fp32 on the CUDA cores,
    # bf16 (fp32 and bf16 banks) on the route the rule names, each call
    # one launch per group of that route's banks
    extra = []
    for b, h, w_, ci, co, n in K2_EXTRA:
        x = torch.randn(b, h, w_, ci, device=dev, generator=gen)
        g = torch.randn(b, h, w_, co, device=dev, generator=gen)
        w = torch.randn(n, 3, 3, ci, co, device=dev, generator=gen) * (
            2.0 / (9 * ci)) ** 0.5
        a = torch.softmax(torch.randn(b, n, device=dev, generator=gen), -1)
        want = k1.adaptive_conv_bwd_w_plain(x, g, w, a)
        route = "tc" if k1.bwd_w_uses_tensor_cores(BF16, ci, co) else "simt"
        per_call = {"tc": -(-n // k1.MAX_BANKS_TC),
                    "simt": -(-n // k1.MAX_BANKS)}
        xb, gb = x.bfloat16(), g.bfloat16()
        (got32, got16), ran = ctx.launches("k2", lambda: (
            k1.adaptive_conv_bwd_w(x, g, w, a),
            [k1.adaptive_conv_bwd_w(xb, gb, wb, a)
             for wb in (w, w.bfloat16())]))
        torch.cuda.synchronize()
        same = [k1.adaptive_conv_bwd_w_plain(xb, gb, wb, a)
                for wb in (w, w.bfloat16())]
        expect = {r: (per_call["simt"] if r == "simt" else 0)
                  + (2 * per_call[route] if r == route else 0)
                  for r in ("tc", "simt")}
        row = dict(b=b, h=h, w=w_, ci=ci, co=co, n=n, route_bf16=route,
                   launches=ran, launches_expected=expect,
                   rel_f32=max_rel(got32, want),
                   rel_bf16=max(max_rel(got, want) for got in got16),
                   rel_same=max(max_rel(got, ref)
                                for got, ref in zip(got16, same)))
        extra.append(row)
        log(f"K2 extra b{b} {h}x{w_} {ci}->{co} n={n}: rel f32 "
            f"{row['rel_f32']:.2e} bf16 ({route}) {row['rel_bf16']:.2e} "
            f"(same inputs {row['rel_same']:.2e}), launches {ran}")
        if not (ran == expect and row["rel_f32"] <= K2_TOL_F32
                and row["rel_bf16"] <= K2_TOL_BF16
                and row["rel_same"] <= K2_TOL_SAME):
            fail(f"K2 extra row failed: {row}")
    ctx.report["k2_extra"] = extra
    # more banks than one K2 launch takes: the wrapper's groups of 4 (CUDA
    # cores) and 2 (tensor cores)
    b, h, ci, co, n = K2_BANKS
    x = torch.randn(b, h, h, ci, device=dev, generator=gen)
    g = torch.randn(b, h, h, co, device=dev, generator=gen)
    w = torch.randn(n, 3, 3, ci, co, device=dev, generator=gen) * (
        2.0 / (9 * ci)) ** 0.5
    a = torch.softmax(torch.randn(b, n, device=dev, generator=gen), -1)
    want = k1.adaptive_conv_bwd_w_plain(x, g, w, a)
    before = (ctx.simt["k2"].launches, ctx.tc["k2"].launches)
    xb, gb = x.bfloat16(), g.bfloat16()
    got32 = k1.adaptive_conv_bwd_w(x, g, w, a)
    got16 = k1.adaptive_conv_bwd_w(xb, gb, w, a)
    torch.cuda.synchronize()
    same = k1.adaptive_conv_bwd_w_plain(xb, gb, w, a)
    row = dict(b=b, h=h, ci=ci, co=co, n=n,
               launches=(ctx.simt["k2"].launches - before[0],
                         ctx.tc["k2"].launches - before[1]),
               rel_f32=max_rel(got32, want), rel_bf16=max_rel(got16, want),
               rel_same=max_rel(got16, same))
    ctx.report["k2_banks"] = row
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


def phase_7_k4_k5(ctx):
    """K4 at phase 4's rows; K5 at the R1 rows, the ragged rows and the
    wider heads' null rows, and at the d = 128 discriminator's R1 shapes."""
    dev, gen = ctx.dev, ctx.gen
    k4_rows, k5_rows = [], []
    for who, b, h, nq, nk, d, l2, null, dtype in attn_rows(ATTN_PATH):
        args = attn_operands(ctx, b, h, nq, nk, d, l2, null, dtype)
        q, k_pre, v, bias, nullk, nullv, null_bias, _ = args
        g = torch.randn(q.shape, device=dev, generator=gen).to(dtype)
        out, lse = k3.flash_attention_fused_fwd(*args)
        bargs = (q, k_pre, v, bias, nullk, nullv, null_bias, g, out, lse, h)
        want = so.flash_attention_fused_bwd_plain(*bargs)
        got = so.flash_attention_fused_bwd(*bargs)
        torch.cuda.synchronize()
        row = dict(
            who=who, b=b, heads=h, nq=nq, nk=nk, d=d, l2=l2, null=null,
            dtype=dtype_name(dtype),
            route="tc" if k3.uses_tensor_cores(dtype, d) else "simt",
            rel=max_rel(got, want))
        k4_rows.append(row)
        log(f"K4 {who} b{b} H{h} nq{nq} nk{nk} d{d} l2={l2} null={null} "
            f"{row['dtype']} ({row['route']}): rel {row['rel']:.2e}")
        if not row["rel"] <= K4_TOL:
            fail(f"K4 disagrees at {row}")
        del got
        # K5 at the R1 shapes of the d_step, at every ragged small row
        # (null or not, dot or L2) and at the wider heads' rows
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
        row5 = dict(
            who=who, b=b, heads=h, nq=nq, nk=nk, d=d, l2=l2, null=null,
            dtype=dtype_name(dtype),
            route="tc" if so.so_uses_tensor_cores(dtype, d) else "simt",
            rel=max_rel(got5, want5))
        k5_rows.append(row5)
        log(f"K5 {who} b{b} H{h} nq{nq} nk{nk} d{d} l2={l2} null={null} "
            f"{row5['dtype']} ({row5['route']}): rel {row5['rel']:.2e}")
        if not row5["rel"] <= K5_TOL:
            fail(f"K5 disagrees at {row5}")
        del want5, got5, args5, cots, args, bargs, want, out, lse, g
        torch.cuda.empty_cache()
    # K5 at the R1 shapes of phase 17's d = 128 discriminator, bf16: on the
    # tensor cores by the rule
    for who, b, h, n, l2 in R1_ATTN_D128:
        d = D128_DIM_HEAD
        args = attn_operands(ctx, b, h, n, n, d, l2, True, BF16)
        g = torch.randn(args[0].shape, device=dev, generator=gen).to(BF16)
        out, lse = k3.flash_attention_fused_fwd(*args)
        bargs = (*args[:7], g, out, lse, h)
        cots = [None if w_ is None else torch.randn(
            w_.shape, device=dev, generator=gen).to(w_.dtype)
            for w_ in so.flash_attention_fused_bwd(*bargs)]
        args5 = (*bargs[:8], lse, *cots, h)
        got5, route = ctx.launched_on(
            "k5", lambda: so.flash_attention_so_bwd2(*args5))
        want5 = so.flash_attention_so_bwd2_plain(*args5)
        torch.cuda.synchronize()
        row5 = dict(
            who=who, b=b, heads=h, nq=n, nk=n, d=d, l2=l2, null=True,
            dtype=dtype_name(BF16), route=route, rel=max_rel(got5, want5))
        k5_rows.append(row5)
        log(f"K5 {who} b{b} H{h} n{n} d{d} l2={l2} null=True bf16 "
            f"({route}): rel {row5['rel']:.2e} [{ctx.smi}]")
        if route != "tc" or not row5["rel"] <= K5_TOL:
            fail(f"K5 at the d = 128 R1 shapes: {row5}")
        del args, g, out, lse, bargs, cots, args5, got5, want5
        torch.cuda.empty_cache()
    ctx.report["k4"], ctx.report["k5"] = k4_rows, k5_rows


def hv_operands(ctx, b, h, nq, nk, d, l2, masked, dtype):
    """Prepared operands of K6a-K7b as the surrogate φ gives them:
    (q, k̂, v, bias), their tangents (tq, t̂k, tv, tbias), and the
    cotangents g (of out) and gt (of tout).  On φ's path k = q with the
    null token first, and the null token has no tangent."""
    dev = ctx.dev

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=ctx.gen)

    q, tq = rnd(b, h, nq, d), rnd(b, h, nq, d)
    if not masked:  # shared q/k, the null token as key 0
        # q (= its keys) drawn with std (64 / d)^(1/4), so that the L2
        # logits spread as at d = 64 (−2√d·std² off the diagonal): at
        # N(0, 1) and d = 128 the softmax over φ's 1025 keys is one-hot to
        # 5e-7 and every cotangent through ĝT and ĝS is a difference at
        # fp32 rounding, so no fp32 arithmetic can be held to a tolerance
        # at such operands
        q = q * (64 / d) ** 0.25
        k = torch.cat((rnd(b, h, 1, d), q), 2)
        tk = torch.cat((torch.zeros(b, h, 1, d, device=dev), tq), 2)
        v = rnd(b, h, nk, d)
        tv = torch.cat((torch.zeros(b, h, 1, d, device=dev),
                        rnd(b, h, nk - 1, d)), 2)
        mask = None
    else:
        k, v, tk, tv = (rnd(b, h, nk, d) for _ in range(4))
        mask = torch.rand(b, nk, device=dev, generator=ctx.gen) > 0.3
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


def hv_route(kname, dtype, d):
    """The route the rule of K6a/K6b (K3/K4's) or K7a/K7b names."""
    rule = (k3.uses_tensor_cores if kname in ("k6a", "k6b")
            else k7.hv_uses_tensor_cores)
    return "tc" if rule(dtype, d) else "simt"


def phase_8_k6_k7(ctx):
    """K6a-K7b at φ's shapes and the small masked rows, each call on the
    route its rule names; then with one sample's keys all masked."""
    rows = []
    for who, b, h, nq, nk, d, l2, masked in HV_PATH:
        for dtype in ((BF16,) if who in HV_BF16_ONLY
                      else (torch.float32, BF16)):
            tol = K67_TOL_F32 if dtype == torch.float32 else K67_TOL_BF16
            operands, tang, g, gt = hv_operands(ctx, b, h, nq, nk, d, l2,
                                                masked, dtype)
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
            row = dict(who=who, bh=b * h, nq=nq, nk=nk, d=d, l2=l2,
                       masked=masked, dtype=dtype_name(dtype),
                       route_k6=hv_route("k6a", dtype, d),
                       route_k7=hv_route("k7a", dtype, d))
            for kname, (kernel, plain) in checks.items():
                got, route = ctx.launched_on(kname, kernel)
                named = row["route_" + kname[:2]]
                if route != named:
                    fail(f"{kname.upper()} at {row} ran on {route}, the "
                         f"rule names {named}")
                want = plain()
                torch.cuda.synchronize()
                row[kname] = max_rel(got, want)
                del got, want
                torch.cuda.empty_cache()
                if not row[kname] <= tol:
                    fail(f"{kname.upper()} disagrees at {row}")
            rows.append(row)
            log(f"K6a-K7b {who} bh{b * h} nq{nq} nk{nk} d{d} l2={l2} "
                f"{row['dtype']} (tol {tol}; K6 on {row['route_k6']}, K7 on "
                f"{row['route_k7']}): "
                + "; ".join(f"{k_} rel {row[k_]:.2e}" for k_ in checks))
            del operands, tang, g, gt, go, out, lse, lse7, checks
            torch.cuda.empty_cache()
    ctx.report["k6_k7"] = rows

    # K6a-K7b where one sample has every key masked, on each route that
    # takes the dtype: finite, and the plain version's numbers (lse exactly
    # NEG_INF on the all-masked rows, from K6a and from K7a)
    masked_rows = []
    for who, b, h, nq, nk, d, l2, masked in K6_ALL_MASKED:
        for dtype in (torch.float32, BF16):
            tol = K67_TOL_F32 if dtype == torch.float32 else K67_TOL_BF16
            operands, tang, g, gt = hv_operands(ctx, b, h, nq, nk, d, l2,
                                                masked, dtype)
            dead = (operands[3] == k6.NEG_INF).all(-1)
            if not dead.any() or dead.all():
                fail(f"the all-masked K6 row has {int(dead.sum())} dead "
                     "rows")
            out, lse = k6.flash_attention_fwd_plain(*operands)
            jvp = k7.flash_attention_hv_jvp_plain(*operands, *tang)
            kernels_ = (
                ("k6", k6, "flash_attention_fwd", "flash_attention_bwd",
                 operands, (*operands, g, out, lse), (out, lse),
                 k6.flash_attention_bwd_plain(*operands, g, out, lse)),
                ("k7", k7, "flash_attention_hv_jvp", "flash_attention_hv_bwd",
                 (*operands, *tang), (*operands, *tang, jvp[2], g, gt), jvp,
                 k7.flash_attention_hv_bwd_plain(*operands, *tang, jvp[2], g,
                                                 gt)))
            for r in ("tc", "simt"):
                ran = [k_ for k_, *_ in kernels_
                       if r == "simt" or hv_route(k_ + "a", dtype, d) == "tc"]
                if not ran:
                    continue
                row = dict(who=who, bh=b * h, nq=nq, nk=nk, d=d,
                           dtype=dtype_name(dtype), route=r,
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
                    row[k_ + "a"] = max_rel((*got_f[:-1], got_l[~dead]),
                                            (*want_f[:-1], want_l[~dead]))
                    row[k_ + "b"] = max_rel(got_b, want_b)
                    del got_f, got_b
                masked_rows.append(row)
                names = [k_ + x for k_ in ran for x in "ab"]
                log(f"K6a-K7b {who} bh{b * h} nq{nq} nk{nk} d{d} "
                    f"{row['dtype']} ({r}, {row['dead_rows']} all-masked "
                    f"rows): finite {row['finite']}, lse NEG_INF there "
                    f"{row['lse_dead_exact']},"
                    + "".join(f" rel {n_.upper()} {row[n_]:.2e}"
                              for n_ in names) + f" (tol {tol})")
                if not (row["finite"] and row["lse_dead_exact"]
                        and max(row[n_] for n_ in names) <= tol):
                    fail(f"K6a-K7b with all-masked rows failed: {row}")
            del operands, tang, g, gt, out, lse, jvp, kernels_
            torch.cuda.empty_cache()
    ctx.report["k6_all_masked"] = masked_rows


# ------------------------------------ phases 9-12, 17: the quickstart pair

def counted_iteration(ctx, gan, i, apply_gp, d_batch, g_batch, seeds):
    """Iteration ``i``: a d_step on ``d_batch`` (R1 if ``apply_gp``) and a
    g_step on ``g_batch`` (the batch, or its size where G draws its
    latents alone), seeded ``seeds[0] + i`` and ``seeds[1] + i``.  Returns
    per step its kind, R1 form, losses and K1-K7b launches."""
    steps = []
    for kind, batch, seed in (("d", d_batch, seeds[0]),
                              ("g", g_batch, seeds[1])):
        before = ctx.read_counts()
        if kind == "d":
            m = gan.train_discriminator_step(
                batch, apply_gradient_penalty=apply_gp,
                calc_multiscale_loss=True, seed=seed + i)
        else:
            m = gan.train_generator_step(batch, calc_multiscale_loss=True,
                                         seed=seed + i)
        after = ctx.read_counts()
        steps.append(dict(
            kind=kind, r1=apply_gp, fwd_over_rev=gan.builder.gp_fwd_over_rev,
            losses={k: float(v) for k, v in m.items()},
            launches={k: after[k] - before[k] for k in after}))
    return steps


def phase_9_10_training(ctx, fwd_over_rev):
    """ITERATIONS iterations of the quickstart pair, R1 on every
    R1_EVERY-th in the form ``fwd_over_rev`` names: finite losses, each
    step's launches those the path implies, all on the tensor cores."""
    label = ("forward-over-reverse R1" if fwd_over_rev
             else "reverse-over-reverse R1")
    data = MockImageDataset(QUICKSTART["image_size"], length=8 * BATCH,
                            seed=0)
    batches = [torch.from_numpy(b_).to(ctx.dev)
               for b_ in data.get_dataloader(BATCH)]
    gan = GigaGAN(generator=QUICKSTART, discriminator=QUICKSTART_D,
                  amp=True, device=ctx.dev.type, seed=0,
                  gp_fwd_over_rev=fwd_over_rev)
    exp_d, exp_d_r1, exp_d_for, exp_g = expected_step_launches(
        len(path_convs(QUICKSTART)), *attention_counts(gan))
    if fwd_over_rev:
        exp_d_r1 = exp_d_for
    ctx.reset_counts()
    steps = []
    for i in range(ITERATIONS):
        steps += counted_iteration(ctx, gan, i, i % R1_EVERY == 0,
                                   batches[i % len(batches)], BATCH,
                                   (1000, 2000))
    launches = ctx.read_counts()
    if any(ctx.simt_counts().values()):
        fail(f"bf16 calls of the {label} path reached the CUDA-core "
             f"kernels: {ctx.simt_counts()}")
    for s in steps:
        want = exp_g if s["kind"] == "g" else (exp_d_r1 if s["r1"]
                                               else exp_d)
        log(f"train ({label}) {s['kind']}_step r1={s['r1']}: launches "
            f"{s['launches']}, losses "
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
    ctx.report["train_steps_fwd_over_rev" if fwd_over_rev
               else "train_steps"] = steps
    del gan, batches
    torch.cuda.empty_cache()


def quickstart_reals(ctx):
    """The first BATCH images of ``MockImageDataset(256, seed=0)``."""
    data = MockImageDataset(QUICKSTART["image_size"], length=8 * BATCH,
                            seed=0)
    return torch.from_numpy(np.stack([data[i] for i in range(BATCH)])).to(
        ctx.dev)


def with_grads(model, metrics):
    """(a step's losses as floats, a copy of each of `model`'s
    gradients)."""
    return ({k: float(v) for k, v in metrics.items()},
            {n_: p.grad.detach().clone()
             for n_, p in model.named_parameters()})


def fp32_step(ctx, real, kind, plain, fwd_over_rev=False, amp=False,
              d_cfg=None):
    """A d_step with R1 (``kind`` "d") or a g_step of the quickstart G and
    ``d_cfg`` (the quickstart D) from the fresh state of seed 0, under
    ``plain_reference()`` if ``plain``: (losses, G's or D's gradients)."""
    g32 = GigaGAN(generator=QUICKSTART, discriminator=d_cfg or QUICKSTART_D,
                  amp=amp, device=ctx.dev.type, seed=0,
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
    res = with_grads(model, m)
    del g32, model
    torch.cuda.empty_cache()
    return res


def compare(label, got, want, loss_keys=None, tol=STEP_TOL_F32,
            stable=None):
    """Losses and every gradient leaf, max-rel, all held to `tol` or,
    given `stable` (an fp32 comparison of the same step), the leaves
    ``informative`` names (moved by at most STABLE_F32 there, G's Noise
    weights and the style network's unresolved leaves excepted); the
    others are logged by name."""
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
        f"(tol {tol})")
    if not (loss_rel <= tol and gated[worst] <= tol):
        fail(f"{label} disagrees: {out}")
    return out


def bf16_step(ctx, real, kind, route, keys, d_cfg=None):
    """A bf16 step of `kind` ("d", "g", or "d_fwd_over_rev": the d_step
    with R1 taken forward-over-reverse) with the kernels `keys` on
    `route`; the step's launches stay counted."""
    ctx.reset_counts()
    with (ctx.simt_kernels(keys) if route == "simt"
          else contextlib.nullcontext()):
        res = fp32_step(ctx, real, kind[0], False,
                        fwd_over_rev=kind != kind[0], amp=True, d_cfg=d_cfg)
    tc = {k_: ctx.tc[k_].launches for k_ in keys}
    sc = {k_: ctx.simt[k_].launches for k_ in keys}
    # K5 runs only in the d_step's R1 double backward, K2 only in the
    # g_step (G's backward)
    ran = [k_ for k_ in keys if k_ != ("k2" if kind[0] == "d" else "k5")]
    used, unused = (tc, sc) if route == "tc" else (sc, tc)
    if not all(used[k_] for k_ in ran) or any(unused.values()):
        fail(f"bf16 {kind}_step on the {route} route launched tensor-core "
             f"{tc} and CUDA-core {sc} kernels")
    return res


def from_plain(kind, res, plain, stable):
    """(max-rel, leaf) of a bf16 step's gated leaves from the fp32 plain
    step: the bf16 noise floor that the route comparison sits on."""
    want = plain[kind][1]
    rel = {n_: rel_err(res[1][n_], want[n_]) for n_ in want
           if informative(n_, stable[kind]["grad_rel"][n_])}
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def start_deterministic_child():
    """Phase 12(d)'s resume under ``torch.use_deterministic_algorithms``,
    in a child process that sets CUBLAS_WORKSPACE_CONFIG before CUDA
    starts; it runs beside phase 11.  Every op of the step has a backward
    without float atomics, so the continued and the resumed trainers must
    be bitwise equal."""
    child = subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()),
         "--deterministic-resume"],
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: child.poll() is None and child.kill())
    return child


def collect_deterministic_child(ctx, child):
    """The child's ``DETERMINISTIC`` result; fails where it differs or the
    mode refused an op."""
    try:
        out, err = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    lines = [ln_ for ln_ in out.splitlines()
             if ln_.startswith("DETERMINISTIC ")]
    det = json.loads(lines[-1][len("DETERMINISTIC "):]) if lines else None
    ctx.report["deterministic_resume"] = dict(result=det,
                                              rc=child.returncode)
    log(f"deterministic resume (child process beside phase 11, rc "
        f"{child.returncode}): {det}")
    if child.returncode != 0 or not det or not det["ok"]:
        log(out[-3000:])
        log(err[-3000:])
        fail("the deterministic resume is not bitwise equal, or the mode "
             f"refused an op: {det}")
    return det


def phase_11_steps(ctx):
    """fp32 steps through the kernels against the same steps on the plain
    path, each from the same fresh state; then bf16 steps through the
    tensor-core K3/K4, K1/K5, K2, K6a/K6b and K7a/K7b against the CUDA-core
    ones, each route also held to its distance from the fp32 plain step.
    Phase 12(d)'s deterministic child runs beside it; returns its
    result, which phase 17 reads."""
    child = start_deterministic_child()
    real = quickstart_reals(ctx)
    plain_step = {kind: fp32_step(ctx, real, kind, True)
                  for kind in ("d", "g")}
    plain_step["d_fwd_over_rev"] = fp32_step(ctx, real, "d", True, True)
    d_ror = fp32_step(ctx, real, "d", False)
    d_for = fp32_step(ctx, real, "d", False, True)
    ctx.report["step_vs_plain_f32"] = step_rel = {}
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
                            fp32_step(ctx, real, "g", False),
                            plain_step["g"])

    for_r1 = (("d_fwd_over_rev", "d_step +R1 forward-over-reverse"),)
    for keys, kinds in (
            (("k3", "k4"), (("d", "d_step +R1"), ("g", "g_step"))),
            (("k1", "k5"), (("d", "d_step +R1"), ("g", "g_step"))),
            (("k2",), (("g", "g_step"),)),
            (("k6a", "k6b"), for_r1),
            (("k7a", "k7b"), for_r1)):
        names = "/".join(k_.upper() for k_ in keys)
        for kind, label in kinds:
            runs = {r: bf16_step(ctx, real, kind, r, keys)
                    for r in ("tc", "simt")}
            key = f"{kind}_bf16_tc_vs_simt_{'_'.join(keys)}"
            step_rel[key] = compare(
                f"bf16 {label}, tensor-core vs CUDA-core {names}",
                runs["tc"], runs["simt"], tol=STEP_TOL_BF16,
                stable=step_rel[kind])
            step_rel[key]["from_fp32_plain"] = far = {
                r: from_plain(kind, res, plain_step, step_rel)
                for r, res in runs.items()}
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
    return collect_deterministic_child(ctx, child)


def phase_17_d128(ctx, det):
    """The quickstart G beside the d = 128 discriminator (4 heads of 128),
    bf16: one d_step+R1 in each form and one g_step from the fresh state,
    every K1-K7b launch on the tensor cores and the counts the path
    implies; each R1 form on the tensor-core K5 (reverse-over-reverse) or
    K7a/K7b (forward-over-reverse) against the CUDA-core ones patched in,
    both held to their distance from the fp32 plain step as phase 11
    holds them.  The bitwise repeat of both R1 forms ran in phase 12(d)'s
    deterministic child (``det``) beside phase 11."""
    d128 = ctx.report["d128"] = dict(
        bitwise=det.get("d128_differs"),
        bitwise_launches=det.get("d128_launches"))
    log(f"d = 128 D: two d_step+R1 from one state and one seed, D's "
        f"gradients bitwise equal in each form (deterministic child): "
        f"differing leaves {det.get('d128_differs')}")
    real = quickstart_reals(ctx)
    probe = GigaGAN(generator=QUICKSTART, discriminator=QUICKSTART_D128,
                    amp=True, device=ctx.dev.type, seed=0)
    exp128 = expected_step_launches(len(path_convs(QUICKSTART)),
                                    *attention_counts(probe))
    del probe
    plain128, stable128 = {}, {}
    for kind, label, keys, want in (
            ("d", "d_step +R1", ("k5",), exp128[1]),
            ("d_fwd_over_rev", "d_step +R1 forward-over-reverse",
             ("k7a", "k7b"), exp128[2])):
        fwd = kind != "d"
        plain128[kind] = fp32_step(ctx, real, "d", True, fwd,
                                   d_cfg=QUICKSTART_D128)
        stable128[kind] = compare(
            f"d = 128 D: fp32 {label} kernels vs plain path",
            fp32_step(ctx, real, "d", False, fwd, d_cfg=QUICKSTART_D128),
            plain128[kind])
        runs, counts = {}, {}
        for r in ("tc", "simt"):
            runs[r] = bf16_step(ctx, real, kind, r, keys,
                                d_cfg=QUICKSTART_D128)
            counts[r] = ctx.read_counts()
            # every launch but those of `keys` on the CUDA-core route is
            # on the tensor cores, in the counts the path implies
            if counts[r] != want or any(
                    ctx.simt[k_].launches for k_ in ctx.simt
                    if r == "tc" or k_ not in keys):
                fail(f"d = 128 D: bf16 {label} on the {r} route launched "
                     f"{counts[r]} (CUDA-core {ctx.simt_counts()}), the "
                     f"path implies {want}")
        if not all(np.isfinite(v) for res in runs.values()
                   for v in res[0].values()):
            fail(f"d = 128 D: non-finite losses in the bf16 {label}: "
                 f"{[res[0] for res in runs.values()]}")
        names = "/".join(k_.upper() for k_ in keys)
        row = compare(f"d = 128 D: bf16 {label}, tensor-core vs CUDA-core "
                      f"{names}", runs["tc"], runs["simt"],
                      tol=STEP_TOL_BF16, stable=stable128[kind])
        far = {r: from_plain(kind, res, plain128, stable128)
               for r, res in runs.items()}
        ratio = far["tc"][0] / far["simt"][0]
        row.update(from_fp32_plain=far, from_fp32_plain_ratio=ratio,
                   launches=counts,
                   fp32_vs_plain=stable128[kind]["grad_rel_max"])
        d128[kind] = row
        log(f"d = 128 D: bf16 {label}, each {names} route vs the fp32 plain "
            f"step: tensor-core {far['tc'][0]:.2e} ({far['tc'][1]}), "
            f"CUDA-core {far['simt'][0]:.2e} ({far['simt'][1]}): ratio "
            f"{ratio:.3f} (limit {FROM_PLAIN_RATIO})")
        if not ratio <= FROM_PLAIN_RATIO:
            fail(f"d = 128 D: bf16 {label}: the tensor-core {names} route "
                 f"sits {ratio:.3f}x as far from the fp32 plain step as the "
                 "CUDA-core one")
        del runs
        torch.cuda.empty_cache()
    del plain128, stable128
    ctx.reset_counts()
    g_losses, _ = fp32_step(ctx, real, "g", False, amp=True,
                            d_cfg=QUICKSTART_D128)
    g_counts = ctx.read_counts()
    if any(ctx.simt_counts().values()) or g_counts != exp128[3] or not all(
            np.isfinite(v) for v in g_losses.values()):
        fail(f"d = 128 D: bf16 g_step losses {g_losses}, launches "
             f"{g_counts} (the path implies {exp128[3]}, all on the tensor "
             "cores)")
    d128["g_step_losses"] = g_losses


def quickstart(ctx, **kw):
    """A quickstart pair of seed 0 unless ``kw`` names one; D takes
    ``remat_stages``."""
    d_cfg = dict(QUICKSTART_D, remat_stages=kw.pop("remat_stages", False))
    kw.setdefault("seed", 0)
    return GigaGAN(generator=QUICKSTART, discriminator=d_cfg,
                   device=ctx.dev.type, **kw)


def counted(ctx, fn):
    """(fn(), the launches of K1-K7b it made)."""
    ctx.reset_counts()
    res = fn()
    return res, ctx.read_counts()


def phase_12_trainer(ctx):
    """The rest of the trainer at the quickstart's full width: gradient
    accumulation, the chunked R1, recomputation and their peaks, and
    train() with its log record, sample grids, save and load."""
    report = ctx.report["trainer"] = {}
    shapes = SyntheticShapesDataset(QUICKSTART["image_size"],
                                    length=MEM_BATCH, seed=7)
    pool = torch.from_numpy(np.stack([shapes[i] for i in range(MEM_BATCH)])
                            ).to(ctx.dev)
    n_convs = len(path_convs(QUICKSTART))

    # (a) accumulation: 4 iterations of 2 microbatches of 4, R1 on one
    gan = quickstart(ctx, amp=True)
    n_attn = attention_counts(gan)
    exp_d, exp_d_r1, _, exp_g = expected_step_launches(n_convs, *n_attn,
                                                       accum=ACCUM)
    mb = BATCH // ACCUM
    accum_steps = []
    for i in range(4):
        apply_gp = i == 2
        for kind in ("d", "g"):
            if kind == "d":
                m, got = counted(ctx, lambda: gan.train_discriminator_step(
                    pool[:BATCH].reshape(ACCUM, mb, *pool.shape[1:]),
                    grad_accum_every=ACCUM, apply_gradient_penalty=apply_gp,
                    calc_multiscale_loss=True, seed=3000 + i))
                want = exp_d_r1 if apply_gp else exp_d
            else:
                m, got = counted(ctx, lambda: gan.train_generator_step(
                    mb, grad_accum_every=ACCUM, calc_multiscale_loss=True,
                    seed=4000 + i))
                want = exp_g
            row = dict(kind=kind, r1=apply_gp, launches=got,
                       losses={k: float(v) for k, v in m.items()})
            accum_steps.append(row)
            log(f"accumulation {ACCUM}x{mb} {kind}_step r1={apply_gp}: "
                f"launches {got}, losses "
                + ", ".join(f"{k} {v:.4g}" for k, v in row["losses"].items()))
            if not all(np.isfinite(v) for v in row["losses"].values()):
                fail(f"non-finite losses with accumulation: {row}")
            if got != want:
                fail(f"{kind}_step with accumulation (r1={apply_gp}) launched "
                     f"{got}, the path implies {want}")
            if any(ctx.simt_counts().values()):
                fail(f"bf16 calls with accumulation reached the CUDA-core "
                     f"kernels: {ctx.simt_counts()}")
    report["accumulation_steps"] = accum_steps
    del gan
    torch.cuda.empty_cache()

    def accum_step(plain):
        g32 = quickstart(ctx)
        with (plain_reference() if plain else contextlib.nullcontext()):
            m = g32.train_discriminator_step(
                pool[:BATCH], grad_accum_every=ACCUM,
                apply_gradient_penalty=True, calc_multiscale_loss=True,
                seed=7)
        res = with_grads(g32.D, m)
        del g32
        torch.cuda.empty_cache()
        return res

    report["accum_vs_plain_f32"] = compare(
        f"fp32 d_step +R1 with accumulation {ACCUM}x{mb}, kernels vs plain "
        "path", accum_step(False), accum_step(True))

    # (b) the chunked R1 against the unchunked one: the penalty runs on the
    # un-augmented pipeline, equal to the unchunked penalty of an unflipped
    # step
    def r1_step(**kw):
        g_ = quickstart(ctx, amp=False, **kw)
        m = g_.train_discriminator_step(
            pool[:BATCH], apply_gradient_penalty=True,
            calc_multiscale_loss=True, seed=7,
            draws=StepDraws(fake_flip=False, real_flip=False))
        res = with_grads(g_.D, m)
        del g_
        torch.cuda.empty_cache()
        return res

    report["chunk_vs_unchunked_f32"] = compare(
        f"fp32 d_step +R1 gp_chunk={CHUNK} vs unchunked, b={BATCH}",
        r1_step(gp_chunk=CHUNK), r1_step(),
        loss_keys=["gradient_penalty"])

    # (c) recomputation (remat, and D's remat_stages) against none, the
    # draws taken from the same seed: a recomputation that drew its noise
    # again would move the gradients far past REMAT_TOL
    for kind in ("d", "g"):
        runs = []
        for kw in ({}, dict(remat=True, remat_stages=True)):
            g_ = quickstart(ctx, **kw)
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
        report[f"remat_vs_none_f32_{kind}"] = compare(
            f"fp32 {kind}_step{' +R1' if kind == 'd' else ''} remat + "
            "remat_stages vs none, same seed", runs[1], runs[0],
            tol=REMAT_TOL)
        del runs

    report["memory"] = trainer_peaks(ctx, pool, n_convs, n_attn)
    trainer_resume(ctx, shapes, pool, report)


def trainer_peaks(ctx, pool, n_convs, n_attn):
    """Phase 12(c)'s bf16 steps at microbatch MEM_BATCH: R1 unchunked,
    chunked, recomputed, and the g_step with and without recomputation,
    each with its launches and the peak device memory of three steps
    after a first one; the chunked R1's peak must be the lower."""
    rows = []
    for kind, label, kw in (
            ("d", "R1", {}),
            ("d", f"R1 gp_chunk={MEM_CHUNK}", dict(gp_chunk=MEM_CHUNK)),
            ("d", "R1 remat_stages", dict(remat_stages=True)),
            ("d", "R1 remat + remat_stages",
             dict(remat=True, remat_stages=True)),
            ("g", "g_step", {}),
            ("g", "g_step remat + remat_stages",
             dict(remat=True, remat_stages=True))):
        g_ = quickstart(ctx, amp=True, **kw)
        want = expected_step_launches(
            n_convs, *n_attn,
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

        step(0)  # the optimizer's state exists before the peak is read
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(1, 4):
            m, launches = counted(ctx, lambda: step(i))
        row = dict(kind=kind, label=label, batch=MEM_BATCH,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches=launches, expected=want,
                   losses={k: float(v) for k, v in m.items()})
        rows.append(row)
        log(f"memory b{MEM_BATCH} bf16 {kind}_step {label}: peak "
            f"{row['peak_gib']:.3f} GiB, launches {launches} [{ctx.smi}]")
        del g_, m
        gc.collect()
        torch.cuda.empty_cache()
        if launches != want:
            fail(f"b{MEM_BATCH} {kind}_step {label} launched {launches}, "
                 f"the path implies {want}")
        if any(ctx.simt_counts().values()):
            fail(f"bf16 calls of {label} reached the CUDA-core kernels: "
                 f"{ctx.simt_counts()}")
        if not all(np.isfinite(v) for v in row["losses"].values()):
            fail(f"non-finite losses: {row}")
    peak = {r["label"]: r["peak_gib"] for r in rows}
    if not peak[f"R1 gp_chunk={MEM_CHUNK}"] < peak["R1"]:
        fail(f"the chunked R1's peak is not lower than the unchunked one's: "
             f"{peak}")
    return rows


def trainer_resume(ctx, shapes, pool, report):
    """Phase 12(d): train() with its log record, then save, load into two
    fresh trainers, and one more iteration of each from the restored
    RNG."""
    models_dir = REPO / "gigagan-models" / "chip_smoke"
    samples_dir = OUT_DIR / "samples"
    records = []
    gan = quickstart(ctx, amp=True, log_steps_every=8,
                     log_hook=records.append, num_samples=9,
                     model_folder=str(models_dir),
                     results_folder=str(samples_dir))
    gan.set_dataloader(shapes.get_dataloader(BATCH))
    _, launches = counted(ctx, lambda: gan.train(24))
    if any(launches[k] == 0 for k in ("k1", "k2", "k3", "k4", "k5")):
        fail(f"a kernel of the train() path was never launched: "
             f"{launches}")
    if any(ctx.simt_counts().values()):
        fail(f"bf16 calls of train() reached the CUDA-core kernels: "
             f"{ctx.simt_counts()}")
    pngs = sorted(p_.name for p_ in samples_dir.glob("*.png"))
    keys = ["step", "G", "MSG", "VG", "D", "MSD", "VD", "GP", "SSL", "CL",
            "MAL", "ms_per_step", "images_per_sec"]
    report["train"] = dict(records=records, pngs=pngs, launches=launches)
    if [r_["step"] for r_ in records] != [1, 8, 16, 24] or any(
            list(r_) != keys for r_ in records):
        fail(f"train() log records: {records}")
    if not all(np.isfinite(v) for r_ in records for v in r_.values()):
        fail("non-finite values in the train() log records")
    if pngs != ["ema-sample-0.png", "sample-0.png"]:
        fail(f"save_sample wrote {pngs}")
    ckpt = models_dir / "resume.ckpt"
    gan.save(ckpt)
    copies = []
    for _ in range(2):  # the second copy measures the step's own noise
        other = quickstart(ctx, amp=True, seed=1,
                           model_folder=str(models_dir),
                           results_folder=str(samples_dir))
        other.load(ckpt)
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
    report["resume"] = dict(state_equal=state_equal,
                            max_diff_after_step=resumed,
                            max_diff_between_loaded=floor, lr=lr)
    log(f"resume: state equal after load {state_equal}; after one more "
        f"iteration max |continued - resumed| {resumed:.3e}, between two "
        f"resumed copies {floor:.3e} (lr {lr})")
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


# --------------------------- phases 13-14: text-to-image and the upsampler

@contextlib.contextmanager
def recording_conv_calls():
    """Every K1 and K2 call inside, by the shapes and dtypes of its
    operands: ``{(kernel, (shape, dtype), ...): calls}``.  The
    dispatchers, which the kernels' autograd Functions look up in their
    module, are wrapped for the window."""
    calls = {}
    dispatch = {"k1": k1.adaptive_conv_fwd, "k2": k1.adaptive_conv_bwd_w}

    def seen(kname):
        def call(*operands):
            key = (kname, *((tuple(t_.shape), t_.dtype) for t_ in operands))
            calls[key] = calls.get(key, 0) + 1
            return dispatch[kname](*operands)
        return call

    k1.adaptive_conv_fwd, k1.adaptive_conv_bwd_w = seen("k1"), seen("k2")
    try:
        yield calls
    finally:
        k1.adaptive_conv_fwd = dispatch["k1"]
        k1.adaptive_conv_bwd_w = dispatch["k2"]


def check_conv_call(ctx, key, n_calls, where):
    """One distinct K1 or K2 call of a path (its operands' shapes and
    dtypes, as recorded at the dispatcher) on fresh operands: as the path
    made it and in fp32, each on the route the rule names, against the
    plain version."""
    kname, (xs, xdt), *rest = key
    rows_, h, w_, ci = xs
    if kname == "k1":
        (ws, wdt), (_, adt), (_, ddt) = rest
    else:
        (_, gdt), (ws, wdt), (_, adt) = rest
    banks, co = ws[0], ws[-1]
    xm, w, a, d = conv_operands(ctx, rows_, h, w_, ci, co, banks)
    if kname == "k1":
        operands = (xm.to(xdt), w.to(wdt), a.to(adt), d.to(ddt))
        want = k1.adaptive_conv_fwd_plain(xm, w, a, d)
        got, route = ctx.route_of("k1", lambda: k1.adaptive_conv_fwd(
            *operands))
        got32, route32 = ctx.route_of("k1", lambda: k1.adaptive_conv_fwd(
            xm, w, a, d))
        rel, rel32 = rel_err(got, want), rel_err(got32, want)
        same, rule = None, k1.conv_uses_tensor_cores
        tol = K1_TOL_BF16 if xdt == BF16 else K1_TOL_F32
        tol32 = K1_TOL_F32
    else:
        g = torch.randn(rows_, h, w_, co, device=ctx.dev, generator=ctx.gen)
        operands = (xm.to(xdt), g.to(gdt), w.to(wdt), a.to(adt))
        want = k1.adaptive_conv_bwd_w_plain(xm, g, w, a)
        got, route = ctx.route_of("k2", lambda: k1.adaptive_conv_bwd_w(
            *operands))
        got32, route32 = ctx.route_of("k2", lambda: k1.adaptive_conv_bwd_w(
            xm, g, w, a))
        rel = max(map(rel_err, got, want))
        rel32 = max(map(rel_err, got32, want))
        same = (max(map(rel_err, got, k1.adaptive_conv_bwd_w_plain(
            *operands))) if xdt == BF16 else None)
        rule = k1.bwd_w_uses_tensor_cores
        tol = K2_TOL_BF16 if xdt == BF16 else K2_TOL_F32
        tol32 = K2_TOL_F32
    routes = (route, route32)
    want_routes = tuple("tc" if rule(dt_, ci, co) else "simt"
                        for dt_ in (xdt, torch.float32))
    entry = dict(kernel=kname, rows=rows_, h=h, w=w_, ci=ci, co=co,
                 banks=banks, dtype=dtype_name(xdt), calls=n_calls,
                 routes=routes, rel=rel, rel_f32=rel32, rel_same=same)
    if routes != want_routes:
        fail(f"{kname} at a {where} shape ran on {routes}; the rule "
             f"names {want_routes}: {entry}")
    if not (rel <= tol and rel32 <= tol32
            and (same is None or same <= K2_TOL_SAME)):
        fail(f"{kname} disagrees with its plain version at a {where} "
             f"shape: {entry}")
    return entry


def check_conv_calls(ctx, calls, where):
    """``check_conv_call`` at every recorded call of the ``where`` path;
    returns the entries."""
    held = []
    for key, n_calls in sorted(calls.items(), key=lambda kv: (
            kv[0][0], -kv[0][1][0][1], kv[0][1][0][0], str(kv[0]))):
        held.append(check_conv_call(ctx, key, n_calls, where))
        torch.cuda.empty_cache()
    worst = {k_: max((e_ for e_ in held if e_["kernel"] == k_),
                     key=lambda e_: e_["rel"]) for k_ in ("k1", "k2")}
    log(f"K1/K2 held at every call of the {where} path: "
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
    return held


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


def step_grads(gan, kind, batch, r1=True, plain=False, f64_attention=False):
    """An fp32 d_step (R1 if ``r1``) or g_step of a fresh trainer, under
    ``plain_reference()`` if ``plain`` and with float64 attention if
    ``f64_attention``: (losses, {"<module>.<leaf>": gradient}) over D and
    the vision-aided D, or G (zeros for a leaf the step left without
    one)."""
    with (plain_reference() if plain else contextlib.nullcontext()), \
            (float64_attention() if f64_attention
             else contextlib.nullcontext()):
        if kind == "d":
            m = gan.train_discriminator_step(
                batch, apply_gradient_penalty=r1, calc_multiscale_loss=True,
                seed=7)
            models = (("D", gan.D), ("VD", gan.VD))
        else:
            m = gan.train_generator_step(batch, calc_multiscale_loss=True,
                                         seed=7)
            models = (("G", gan.G),)
    return ({k: float(v) for k, v in m.items()},
            {f"{name_}.{n_}": (p.grad if p.grad is not None else
                               torch.zeros_like(p)).detach().clone()
             for name_, mod in models if mod is not None
             for n_, p in mod.named_parameters()})


def phase_13_t2i(ctx):
    """The text-conditioned recipe at full width: CLIP, the text encoders,
    cross-attention, the conditional D, the vision-aided D, the
    matching-aware and contrastive losses."""
    t2i = ctx.report["t2i"] = {}
    clip = OpenClipAdapter(seed=0, device=ctx.dev.type)

    def t2i_gan(**kw):
        kw.setdefault("seed", 0)
        return GigaGAN(generator=T2I_G, discriminator=T2I_D,
                       vision_aided_discriminator=T2I_VD, clip=clip,
                       allow_mock_clip=True, device=ctx.dev.type, **kw)

    gan = t2i_gan(amp=True)
    n_g = len(path_convs(T2I_G))
    n_ga, n_da = attention_counts(gan)
    n_p, n_v = t2i_structure(gan)
    n_x = sum(st.cross_attn is not None for st in gan.G.stages)
    t2i["structure"] = dict(g_convs=n_g, g_attn=n_ga, g_cross_attn=n_x,
                            d_attn=n_da, predictor_convs=n_p, vd_convs=n_v)
    log(f"text-to-image G+D+VD (+ frozen CLIP): {n_x} cross-attention "
        f"blocks, {n_p} predictor and {n_v} VD adaptive convs")
    exp_d, exp_d_r1, exp_d_for, exp_g = expected_t2i_launches(
        n_g, n_ga, n_da, n_p, n_v)
    text_data = MockTextImageDataset(T2I_G["image_size"],
                                     length=8 * BATCH, seed=0)
    text_iter = cycle(text_data.get_dataloader(BATCH))
    batches = []
    for i in range(4):  # each batch's captions embedded once, as train()
        b_ = gan._collect_batch(text_iter, 1)
        b_["real_images"] = torch.from_numpy(b_["real_images"]).to(ctx.dev)
        # distinct captions: the matching-aware rows and the contrastive
        # pool then pair each image with another text
        b_["text_embeds"], b_["text_encodings"] = (
            t_[None] for t_ in clip.embed_texts(
                (T2I_CAPTIONS[i:] + T2I_CAPTIONS[:i])[:BATCH]))
        batches.append(b_)

    # every K1 and K2 call of the path's run and of its sampling is held
    # against its plain version below
    with recording_conv_calls() as calls:
        ctx.reset_counts()
        steps = []
        for i in range(ITERATIONS + 2):  # the last 2 forward-over-reverse
            gan.builder.gp_fwd_over_rev = i >= ITERATIONS
            steps += counted_iteration(
                ctx, gan, i, i >= ITERATIONS or i % R1_EVERY == 0,
                batches[2 * i % len(batches)],
                batches[(2 * i + 1) % len(batches)], (5000, 6000))
        launches = ctx.read_counts()
        gan.builder.gp_fwd_over_rev = False
        if any(ctx.simt_counts().values()):
            fail(f"bf16 calls of the text-to-image path reached the "
                 f"CUDA-core kernels: {ctx.simt_counts()}")
        nonzero = {"d": ["vision_aided_divergence", "matching_aware_loss"],
                   "g": ["total_vd_divergence", "contrastive_loss"]}
        for s_ in steps:
            want = exp_g if s_["kind"] == "g" else (
                exp_d if not s_["r1"] else exp_d_for if s_["fwd_over_rev"]
                else exp_d_r1)
            log(f"text-to-image {s_['kind']}_step r1={s_['r1']}"
                f"{' (forward-over-reverse)' if s_['fwd_over_rev'] else ''}"
                f": launches {s_['launches']}, losses "
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
                fail(f"text-to-image {s_['kind']}_step (r1={s_['r1']}) "
                     f"launched {s_['launches']}, the path implies {want}")
        used = [k for k in KERNEL_NAMES
                if any(row[k] for row in (exp_d, exp_d_r1, exp_d_for, exp_g))]
        if any(launches[k] == 0 for k in used):
            fail(f"a kernel of the text-to-image path was never launched: "
                 f"{launches}")
        log(f"text-to-image path: {ITERATIONS} iterations (R1 on 0 and 4) "
            f"and 2 forward-over-reverse R1 iterations, launches {launches}")
        t2i["steps"], t2i["launches"] = steps, launches

        # sampling from captions, batch 1 and 8: K1 and the demodulation
        # per G conv and K3 per G attention per forward issued from Python,
        # two per batch size (the eager first call and the capture of its
        # graph; later calls replay it); cross-attention and the text
        # encoder run no kernel (77 keys: the plain attention)
        ctx.reset_counts()
        for i in range(5):
            for bs in (1, BATCH):
                img = gan.generate(texts=T2I_CAPTIONS[:bs], seed=i)
                size = T2I_G["image_size"]
                if img.shape != (bs, size, size, 3) or not np.isfinite(
                        img).all():
                    fail(f"text-to-image sampling gave {img.shape} / "
                         "non-finite")
        counts = ctx.read_counts()
        per = {k: 0 for k in counts}
        per.update(k1=4 * n_g, k3=4 * n_ga, demod=4 * n_g)
        if counts != per:
            fail(f"text-to-image sampling launched {counts}, the path "
                 f"implies {per}")
        t2i["sampling_launches"] = counts
    del gan
    gc.collect()
    torch.cuda.empty_cache()

    # fp32 steps through the kernels against the plain path, from one fresh
    # state: the d_step with the matching rows folded in, d_step + R1 (both
    # forms) and g_step; D's and the VD's gradients, or G's.  The reference
    # is the plain path with its attention in float64: D's self-attention
    # shares q and k, so each to_q gradient is the sum of a q-side and a
    # k-side term several times its size that cancel, and an fp32
    # attention leaves a part of that leaf in doubt, in the plain path as
    # in the kernels.  Two fp32 paths would be held to the sum of their
    # roundings; against float64 attention each is held to its own
    t2i["fp32_vs_plain"] = {}
    for kind, label, fwd_over_rev, r1 in (
            ("d", "d_step (matching rows folded)", False, False),
            ("d", "d_step +R1", False, True),
            ("d", "d_step +R1 forward-over-reverse", True, True),
            ("g", "g_step", False, False)):
        runs = []
        for plain in (True, False):
            g32 = t2i_gan(gp_fwd_over_rev=fwd_over_rev)
            runs.append(step_grads(g32, kind, batches[0], r1, plain=plain,
                                   f64_attention=plain))
            del g32
            gc.collect()
            torch.cuda.empty_cache()
        t2i["fp32_vs_plain"][label] = compare(
            f"text-to-image fp32 {label}, kernels vs plain path with "
            "float64 attention", runs[1], runs[0])
        del runs

    # K1 and K2 at every shape and dtype the path gave them (the run and the
    # sampling above), against their plain versions on fresh operands of
    # those shapes: the call as the path made it, on the route the rule
    # names, and in fp32 on its route
    t2i["conv_calls"] = check_conv_calls(ctx, calls, "text-to-image")
    del batches, clip
    gc.collect()
    torch.cuda.empty_cache()


def phase_14_upsampler(ctx):
    """The UNet upsampler recipe at full width: its training iterations,
    sampling (and a 256 -> 1024 request), fp32 steps against the plain
    path, a video forward, the fused attention chain past its grid limit,
    K1-K4 at its shapes and the linear-attention kernel at the request's."""
    up = ctx.report["upsampler"] = {}

    def up_gan(**kw):
        kw.setdefault("seed", 0)
        return GigaGAN(generator=UPSAMPLER_G, discriminator=UPSAMPLER_D,
                       train_upsampler=True, device=ctx.dev.type, **kw)

    gan = up_gan(amp=True)
    n_g, n_ga = upsampler_structure(UPSAMPLER_G)
    n_la = upsampler_linear_attentions(UPSAMPLER_G)
    n_da = sum(st.core.attn is not None for st in gan.D.stages)
    built = (sum(isinstance(m, AdaptiveConv) for m in gan.G.modules()),
             sum(isinstance(m, Attention2D) for m in gan.G.modules()),
             sum(isinstance(m, LinearAttention2D) for m in gan.G.modules()))
    up["structure"] = dict(g_convs=n_g, g_attn=n_ga, g_linear_attn=n_la,
                           d_attn=n_da)
    log(f"upsampler G+D: {n_g} adaptive convs, {n_ga} full and {n_la} "
        f"linear attentions in G, {n_da} attentions in D")
    if built != (n_g, n_ga, n_la):
        fail(f"the upsampler holds {built} adaptive convs, full and linear "
             f"attentions, its configuration implies {(n_g, n_ga, n_la)}")
    exp_d, exp_d_r1, exp_d_for, exp_g = expected_upsampler_launches(
        UPSAMPLER_G, n_da)
    size = UPSAMPLER_G["image_size"]
    data = MockImageDataset(size, length=4 * BATCH, seed=0)
    pool = torch.from_numpy(np.stack(
        [data[i] for i in range(4 * BATCH)])).to(ctx.dev)

    def quarter(j):
        return pool[j % 4 * BATCH:(j % 4 + 1) * BATCH]

    with recording_conv_calls() as calls:
        ctx.reset_counts()
        steps = []
        for i in range(ITERATIONS + 2):  # the last 2 forward-over-reverse
            gan.builder.gp_fwd_over_rev = i >= ITERATIONS
            steps += counted_iteration(
                ctx, gan, i, i >= ITERATIONS or i % R1_EVERY == 0,
                quarter(2 * i), quarter(2 * i + 1), (9000, 9500))
        launches = ctx.read_counts()
        gan.builder.gp_fwd_over_rev = False
        if any(ctx.simt_counts().values()):
            fail(f"bf16 calls of the upsampler path reached the CUDA-core "
                 f"kernels: {ctx.simt_counts()}")
        for s_ in steps:
            want = exp_g if s_["kind"] == "g" else (
                exp_d if not s_["r1"] else exp_d_for if s_["fwd_over_rev"]
                else exp_d_r1)
            log(f"upsampler {s_['kind']}_step r1={s_['r1']}"
                f"{' (forward-over-reverse)' if s_['fwd_over_rev'] else ''}"
                f": launches {s_['launches']}, losses "
                + ", ".join(f"{k} {v:.4g}" for k, v in s_["losses"].items()))
            if not all(np.isfinite(v) for v in s_["losses"].values()):
                fail(f"non-finite losses in {s_}")
            if s_["kind"] == "d" and s_["r1"] and \
                    s_["losses"]["gradient_penalty"] == 0.0:
                fail(f"upsampler d_step: the R1 penalty is zero: {s_}")
            if s_["launches"] != want:
                fail(f"upsampler {s_['kind']}_step (r1={s_['r1']}) launched "
                     f"{s_['launches']}, the path implies {want}")
        if any(n_ == 0 for n_ in launches.values()):
            fail(f"a kernel of the upsampler path was never launched: "
                 f"{launches}")
        log(f"upsampler path: {ITERATIONS} iterations (R1 on 0 and 4) and "
            f"2 forward-over-reverse R1 iterations, launches {launches}")
        up["steps"], up["launches"] = steps, launches
        upsampler_sampling(ctx, gan, pool, n_g, n_ga, n_la)
    del gan
    gc.collect()
    torch.cuda.empty_cache()

    # fp32 steps through the kernels against the plain path with float64
    # attention (phase 13's reference), from one fresh state: d_step+R1 in
    # both forms and g_step
    up["fp32_vs_plain"] = {}
    for kind, label, fwd_over_rev in (
            ("d", "d_step +R1", False),
            ("d", "d_step +R1 forward-over-reverse", True),
            ("g", "g_step", False)):
        runs = []
        for plain in (True, False):
            g32 = up_gan(gp_fwd_over_rev=fwd_over_rev)
            runs.append(step_grads(g32, kind, pool[:UP_FP32_BATCH],
                                   plain=plain, f64_attention=plain))
            del g32
            gc.collect()
            torch.cuda.empty_cache()
        up["fp32_vs_plain"][label] = compare(
            f"upsampler fp32 b{UP_FP32_BATCH} {label}, kernels vs plain "
            "path with float64 attention", runs[1], runs[0])
        del runs
    del pool
    gc.collect()
    torch.cuda.empty_cache()

    up["video"] = upsampler_video(ctx)
    up["split"] = attention_past_grid_limit(ctx)
    # K1 and K2 at every shape and dtype of the run, the sampling and the
    # 1024 request, against their plain versions
    up["conv_calls"] = check_conv_calls(ctx, calls, "upsampler")
    up["attention"] = upsampler_attention(ctx)
    up["linear_attention"] = upsampler_linear_attention(ctx)


def upsampler_sampling(ctx, gan, pool, n_g, n_ga, n_la):
    """generate(lowres) at batch 1 and 8, K1 and the demodulation per
    adaptive conv, K3 per attention and the linear-attention kernel per
    linear attention of G per forward (eager: the upsampler's forward is
    not graphed; every bf16 linear attention without gradient on the
    kernel), and a batch-1 256 -> 1024 request with the same widths (K1 on
    1024² maps, K3 at 16384 tokens, linear attention over 1M tokens)."""
    size = UPSAMPLER_G["image_size"]
    lowres = ops.resize_image_to(pool[:BATCH], UPSAMPLER_G[
        "input_image_size"], "nearest").cpu().numpy()
    ctx.reset_counts()
    for i in range(4):
        for bs in (1, BATCH):
            img = gan.generate(lowres[:bs], seed=i)
            if img.shape != (bs, size, size, 3) or not np.isfinite(
                    img).all():
                fail(f"upsampler sampling gave {img.shape} / non-finite")
    counts = ctx.read_counts()
    per = {k: 0 for k in counts}
    per.update(k1=8 * n_g, k3=8 * n_ga, demod=8 * n_g, linattn=8 * n_la)
    if counts != per:
        fail(f"upsampler sampling launched {counts}, the path implies {per}")
    ctx.report["upsampler"]["sampling_launches"] = counts

    big = GigaGAN(generator=UPSAMPLER_1K, train_upsampler=True, amp=True,
                  device=ctx.dev.type, seed=0)
    lowres_1k = np.random.default_rng(0).random(
        (1, 256, 256, 3)).astype(np.float32)
    ctx.reset_counts()
    for i in range(3):
        img = big.generate(lowres_1k, seed=1 + i)
    counts = ctx.read_counts()
    if img.shape != (1, 1024, 1024, 3) or not np.isfinite(img).all():
        fail(f"the 256 -> 1024 request gave {img.shape} / non-finite")
    per = {k: 0 for k in counts}
    per.update(k1=3 * n_g, k3=3 * n_ga, demod=3 * n_g, linattn=3 * n_la)
    if counts != per:
        fail(f"the 256 -> 1024 request launched {counts}, the path implies "
             f"{per}")
    ctx.report["upsampler"]["sampling_1k_launches"] = counts
    del big
    gc.collect()
    torch.cuda.empty_cache()


def upsampler_video(ctx):
    """The video net, fp32, one clip, against the plain path: every K3
    launch of the forward takes at most MAX_BATCH rows, and the last up
    stage's temporal attention (256² rows) splits."""
    dev = ctx.dev
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
    try:
        with torch.no_grad():
            got = vid(clip_in, noise=vnoise)
    finally:
        for r_, e_ in k3_entries.items():
            setattr(k3, f"flash_attention_fused_fwd_{r_}", e_)
    with torch.no_grad(), plain_reference():
        want = vid(clip_in, noise=vnoise)
    # frames double at every up stage and halve at every down stage that
    # pools
    stages = len(UPSAMPLER_VIDEO["dim_mults"])
    pools = stages - int(np.log2(UPSAMPLER_VIDEO["image_size"] // inp))
    frames = VIDEO_FRAMES * 2 ** stages // 2 ** pools
    rel = rel_err(got, want)
    video = dict(shape=list(got.shape), rel=rel,
                 k3_batches=sorted(set(k3_batches)),
                 k3_launches=len(k3_batches))
    log(f"upsampler video fp32, {VIDEO_FRAMES} frames {inp}² -> "
        f"{tuple(got.shape)}: kernels vs plain path rel {rel:.2e} (tol "
        f"{VIDEO_TOL}), {len(k3_batches)} K3 launches, batches "
        f"{sorted(set(k3_batches))}")
    if tuple(got.shape) != (1, frames, 256, 256, 3) or not bool(
            torch.isfinite(got).all()) or not rel <= VIDEO_TOL:
        fail(f"the video forward disagrees: {video}")
    if max(k3_batches, default=0) > k3.MAX_BATCH or \
            k3.MAX_BATCH not in k3_batches:
        fail(f"the video forward's K3 launches took batches "
             f"{sorted(set(k3_batches))}: the 65536-row temporal attention "
             "did not split at the grid limit")
    del vid, got, want, clip_in
    gc.collect()
    torch.cuda.empty_cache()
    return video


def attention_past_grid_limit(ctx):
    """K3, K4 and K5 past the grid limit: a batch of 65536 + 8 at the
    video temporal attention's size (16 tokens), with and without the null
    token, fp32 and bf16; each call must run as two launches."""
    rows = []
    for null in (False, True):
        for dtype in (torch.float32, BF16):
            args = attn_operands(ctx, SPLIT_ROWS, HEADS, 16, 16, DIM_HEAD,
                                 null, null, dtype)
            q, k_pre, v, bias, nullk, nullv, null_bias, _ = args
            route = "tc" if k3.uses_tensor_cores(dtype, DIM_HEAD) else "simt"
            route5 = ("tc" if so.so_uses_tensor_cores(dtype, DIM_HEAD)
                      else "simt")
            entries = {k_: (ctx.tc if r_ == "tc" else ctx.simt)[k_]
                       for k_, r_ in (("k3", route), ("k4", route),
                                      ("k5", route5))}
            before = {k_: e_.launches for k_, e_ in entries.items()}
            out, lse = k3.flash_attention_fused_fwd(*args)
            o_want, l_want = k3.flash_attention_fused_fwd_plain(*args)
            g = torch.randn(q.shape, device=ctx.dev,
                            generator=ctx.gen).to(dtype)
            bargs = (q, k_pre, v, bias, nullk, nullv, null_bias, g, out,
                     lse, HEADS)
            got4 = so.flash_attention_fused_bwd(*bargs)
            want4 = so.flash_attention_fused_bwd_plain(*bargs)
            cots = [None if w_ is None else torch.randn(
                w_.shape, device=ctx.dev, generator=ctx.gen).to(w_.dtype)
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
                rel_k4=max_rel(got4, want4), rel_k5=max_rel(got5, want5))
            rows.append(row)
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
    return rows


def upsampler_attention(ctx):
    """K3 and K4 at G's three attention shapes (8 heads of 64, dot
    product, no null token; 5 layers at 1024, 256, 64, 256 and 1024
    tokens), and K3 at the 1024 request's 16384 tokens."""
    rows = []
    for b, n in ((BATCH, 1024), (BATCH, 256), (BATCH, 64), (1, 16384)):
        args = attn_operands(ctx, b, HEADS, n, n, DIM_HEAD, False, False,
                             BF16)
        o_want, l_want = k3.flash_attention_fused_fwd_plain(*args)
        out, lse = k3.flash_attention_fused_fwd(*args)
        row = dict(b=b, n=n, rel_k3=max(rel_err(out, o_want),
                                        rel_err(lse, l_want)))
        del o_want, l_want
        if n <= 1024:
            g = torch.randn(args[0].shape, device=ctx.dev,
                            generator=ctx.gen).to(BF16)
            bargs = (*args[:7], g, out, lse, HEADS)
            want4 = so.flash_attention_fused_bwd_plain(*bargs)
            got4 = so.flash_attention_fused_bwd(*bargs)
            row["rel_k4"] = max_rel(got4, want4)
            del g, bargs, want4, got4
        rows.append(row)
        log(f"K3/K4 upsampler G b{b} H{HEADS} n{n} d{DIM_HEAD} bf16: rel K3 "
            f"{row['rel_k3']:.2e}"
            + (f" K4 {row['rel_k4']:.2e}" if "rel_k4" in row else ""))
        if not (row["rel_k3"] <= K3_TOL
                and row.get("rel_k4", 0.0) <= K4_TOL):
            fail(f"K3/K4 disagree at an upsampler shape: {row}")
        del args, out, lse
        torch.cuda.empty_cache()
    return rows


def upsampler_linear_attention(ctx):
    """The linear-attention kernel at the 1024 request's six calls (8
    heads of 64, batch 1: three at 256², then 256², 512² and 1024²), on
    the ``to_qkv`` chunk views: its distance from a float64 evaluation on
    the same bf16 operands against the plain bf16 form's
    (LINATTN_FROM_F64_RATIO), two calls bitwise equal."""
    rows = []
    hd = HEADS * DIM_HEAD
    for n in [256 ** 2] * 4 + [512 ** 2, 1024 ** 2]:
        qkv = torch.randn(1, n, 3 * hd, device=ctx.dev,
                          generator=ctx.gen).to(BF16)
        q, k, v = qkv.chunk(3, dim=-1)
        before = klinattn.linear_attend_cuda.launches
        got = ops.linear_attend_fused(q, k, v, heads=HEADS)
        again = ops.linear_attend_fused(q, k, v, heads=HEADS)
        launched = klinattn.linear_attend_cuda.launches - before
        plain = klinattn.linear_attend_plain(q, k, v, heads=HEADS)
        qd, kd, vd = (t.double().reshape(1, n, HEADS, DIM_HEAD)
                      for t in (q, k, v))
        context = torch.einsum("bnhd,bnhe->bhde", torch.softmax(kd, 1), vd)
        want = torch.einsum("bnhd,bhde->bnhe",
                            torch.softmax(qd, -1) * DIM_HEAD ** -0.5,
                            context).reshape(1, n, hd)
        del qd, kd, vd
        gaps = [float((t.double() - want).norm() / want.norm())
                for t in (got, plain)]
        row = dict(n=n, kernel=gaps[0], plain=gaps[1], launches=launched,
                   repeats=bool(torch.equal(got, again)))
        rows.append(row)
        log(f"linear attention b1 H{HEADS} n{n} bf16: kernel {gaps[0]:.3e}, "
            f"plain {gaps[1]:.3e} from float64")
        if launched != 2 or not row["repeats"] or not (
                gaps[0] <= LINATTN_FROM_F64_RATIO * gaps[1]):
            fail(f"the linear-attention kernel disagrees: {row}")
        del qkv, q, k, v, got, again, plain, want, context
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------ phase 16: outer surface

def run_cli(cli_dir, surface, label, *args):
    """One command of the CLI in a child process: (stdout, launches)."""
    counts_path = cli_dir / f"{label}.launches.json"
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--cli-child",
         str(counts_path), *args], cwd=REPO, capture_output=True,
        text=True, timeout=CLI_TIMEOUT_S)
    (cli_dir / f"{label}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"CLI {label} ({' '.join(args)}) exited "
             f"{proc.returncode}: {proc.stderr[-3000:]}")
    counts = json.loads(counts_path.read_text())
    surface["cli"][label] = dict(args=list(args), launches=counts)
    log(f"CLI {label}: launches {routes_line(counts)}")
    return proc.stdout, counts


def launched_on_tc(label, counts, kernels):
    missing = [k_ for k_ in kernels if not counts[k_]["tc"]]
    if missing or on_cuda_cores(counts):
        fail(f"CLI {label}: kernels {missing} not launched on the "
             f"tensor cores, or a bf16 launch on the CUDA cores: "
             f"{counts}")


def png_of(path, shape):
    """A PNG's pixels, of ``shape`` (an early grid may be one colour:
    the quickstart G's first outputs clip to white)."""
    img = decode_png(pathlib.Path(path).read_bytes())
    if img.shape != shape:
        fail(f"{path}: shape {img.shape} (want {shape})")
    return img


def finite_checkpoint(path, steps):
    saved = torch.load(path, map_location="cpu", weights_only=True)
    bad = [f"{m_}.{n_}" for m_ in ("G", "G_ema", "D")
           for n_, v in saved[m_].items()
           if v.is_floating_point() and not torch.isfinite(v).all()]
    if saved["steps"] != steps or bad:
        fail(f"{path}: steps {saved['steps']} (want {steps}), "
             f"non-finite {bad[:3]}")


def grid(n, s):
    """The shape of an n x n grid of s x s images with 2-pixel borders."""
    return (n * s + (n + 1) * 2, n * s + (n + 1) * 2, 3)


def phase_16_surface(ctx):
    """The outer surface: the command line, JAX-written model folders, and
    data parallel on the one card.  Checkpoints (1.14 GiB each) and the
    trainers' sample grids go to the gitignored gigagan-models/ and are
    deleted after their checks."""
    cli_dir = OUT_DIR / "cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    cli_dir.mkdir(parents=True)
    surface = ctx.report["surface"] = {"cli": {}}
    cli_commands(cli_dir, surface)
    jax_folders(ctx, cli_dir, surface)
    surface["dp"] = data_parallel(ctx, cli_dir)


def cli_commands(cli_dir, surface):
    """Phase 16(a): the command line at the quickstart's full width."""
    cli_models = REPO / "gigagan-models" / "chip_smoke_cli"
    up_models = REPO / "gigagan-models" / "chip_smoke_cli_upsampler"
    grids = REPO / "gigagan-models" / "chip_smoke_cli_results"
    for d_ in (cli_models, up_models, grids):
        shutil.rmtree(d_, ignore_errors=True)
    common = ["--mock-data", "--batch-size", str(BATCH), "--models",
              str(cli_models)]
    _, counts = run_cli(cli_dir, surface, "train", "train", *common,
                        "--steps", "8", "--save-every", "4", "--results",
                        str(grids / "train"))
    launched_on_tc("train", counts, ("k1", "k2", "k3", "k4", "k5"))
    for m_ in range(3):  # saved after iterations 1, 4 and 8
        png_of(grids / "train" / f"ema-sample-{m_}.png", grid(5, 256))
    finite_checkpoint(cli_models / "model-2.ckpt", 9)
    out_, counts = run_cli(cli_dir, surface, "train_resume", "train",
                           *common, "--resume", "--steps", "2",
                           "--save-every", "2", "--results",
                           str(grids / "resume"))
    if f"resuming from {cli_models / 'model-2.ckpt'}" not in out_:
        fail(f"train --resume did not resume from model-2.ckpt: {out_}")
    launched_on_tc("train_resume", counts, ("k1", "k2", "k3", "k4"))
    finite_checkpoint(cli_models / "model-5.ckpt", 11)
    _, counts = run_cli(cli_dir, surface, "generate", "generate", "--models",
                        str(cli_models), "--num", "16", "--seed", "0",
                        "--out", str(cli_dir / "samples.png"))
    launched_on_tc("generate", counts, ("k1", "k3"))
    png_of(cli_dir / "samples.png", grid(4, 256))
    _, counts = run_cli(cli_dir, surface, "evaluate", "evaluate", "--models",
                        str(cli_models), "--mock-data", "--num", "64",
                        "--batch", "8", "--out",
                        str(cli_dir / "evaluate.json"))
    launched_on_tc("evaluate", counts, ("k1", "k3"))
    rec = json.loads((cli_dir / "evaluate.json").read_text())
    if not (rec["clip_is_real"] is False and rec["mock_reasons"]
            and rec["n_real"] == rec["n_fake"] == 64
            and math.isfinite(rec["clip_fid"]) and rec["clip_fid"] >= 0
            and rec["steps_trained"] == 11):
        fail(f"evaluate: {rec}")
    surface["evaluate"] = rec
    _, counts = run_cli(cli_dir, surface, "train_upsampler",
                        "train-upsampler", "--mock-data", "--steps", "4",
                        "--batch-size", "4", "--models", str(up_models),
                        "--results", str(grids / "upsampler"))
    launched_on_tc("train_upsampler", counts,
                   ("k1", "k2", "k3", "k4", "k5"))
    finite_checkpoint(up_models / "model-0.ckpt", 2)
    low = (MockImageDataset(64, seed=0)[0] * 255).astype(np.uint8)
    (cli_dir / "low64.png").write_bytes(encode_png(low))
    _, counts = run_cli(cli_dir, surface, "upsample", "upsample", "--models",
                        str(up_models), "--input", str(cli_dir / "low64.png"),
                        "--seed", "0", "--out",
                        str(cli_dir / "upsampled256.png"))
    launched_on_tc("upsample", counts, ("k1", "k3"))
    png_of(cli_dir / "upsampled256.png", (256, 256, 3))
    for d_ in (cli_models, up_models, grids):
        shutil.rmtree(d_, ignore_errors=True)


def jax_folders(ctx, cli_dir, surface):
    """Phase 16(b): the model folders the JAX package wrote: its CLI's (a
    flax msgpack checkpoint) and the same state saved by its trainer with
    checkpoint_backend="orbax" (a directory: OCDBT, zarr v2, zstd)."""
    fixture = REPO / "tests" / "torch_fixtures"
    outs = fixture / "jax_outputs"
    latents = torch.from_numpy(np.load(outs / "latents.npy")).to(ctx.dev)
    noises = [torch.from_numpy(np.load(p_)).to(ctx.dev)
              for p_ in sorted(outs.glob("noise_*.npy"))]
    loaded = {}
    for label, folder_name in (("jax_folder", "jax_model"),
                               ("jax_orbax_folder", "jax_model_orbax")):
        folder = cli_dir / folder_name
        shutil.copytree(fixture / folder_name, folder)
        samples = cli_dir / f"{folder_name}_samples.png"
        run_cli(cli_dir, surface, f"generate_{label}", "generate",
                "--models", str(folder), "--num", "4", "--seed", "0",
                "--out", str(samples))
        png_of(samples, grid(2, 16))
        jgan, jckpt = port_cli._load_model_folder(folder, ctx.dev.type)
        ctx.reset_counts()
        jax_rows = {}
        with torch.no_grad():
            for key, module in (("g", jgan.G), ("g_ema", jgan.G_ema)):
                got = module(noise=latents, pixel_noise=noises).float().cpu()
                jax_rows[key] = rel_err(got, torch.from_numpy(
                    np.load(outs / f"{key}.npy")))
        torch.cuda.synchronize()
        jax_counts = ctx.read_counts()
        surface[label] = dict(checkpoint=jckpt.name, steps=jgan.steps,
                              rel=jax_rows, launches=jax_counts)
        log(f"JAX-written folder {folder_name}/{jckpt.name} (steps "
            f"{jgan.steps}), fp32 through the kernels: rel G "
            f"{jax_rows['g']:.2e}, G_ema {jax_rows['g_ema']:.2e} (limit "
            f"{JAX_FOLDER_TOL}); launches {jax_counts}")
        if not (max(jax_rows.values()) <= JAX_FOLDER_TOL
                and jax_counts["k1"] and jax_counts["k3"]):
            fail(f"the JAX-written folder {folder_name}: {surface[label]}")
        loaded[label] = {f"{m_}.{n_}": v.detach().cpu()
                         for m_ in ("G", "G_ema")
                         for n_, v in getattr(jgan, m_).state_dict().items()}
        del jgan
    unequal = [n_ for n_, v in loaded["jax_folder"].items()
               if not torch.equal(v, loaded["jax_orbax_folder"][n_])]
    if loaded["jax_folder"].keys() != loaded["jax_orbax_folder"].keys() \
            or unequal:
        fail(f"the orbax folder's G and G_ema differ from the msgpack "
             f"folder's: {unequal[:5]}")
    log(f"JAX checkpoints: G and G_ema of the two folders bitwise equal "
        f"({len(loaded['jax_folder'])} tensors)")


def run_ranks(cli_dir, dp_dir, world, backend, modes, label):
    """``world`` ranks of ``dp_child`` on the card over ``backend``; rank
    0's result."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    specs = [dict(rank=r_, world=world, port=port, backend=backend,
                  modes=modes, out=str(cli_dir / f"dp_{label}.json"),
                  fp32_out=str(dp_dir / f"{label}_fp32.pt"))
             for r_ in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--dp-child",
         json.dumps(spec)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for spec in specs]
    logs = []
    try:
        for r_, proc in enumerate(procs):
            logs.append(proc.communicate(timeout=CLI_TIMEOUT_S)[0])
            (cli_dir / f"dp_{label}_rank{r_}.log").write_text(logs[-1])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    bad = [r_ for r_, proc in enumerate(procs) if proc.returncode]
    if bad:
        fail(f"data-parallel {label}: ranks {bad} failed: "
             f"{logs[bad[0]][-3000:]}")
    return json.loads((cli_dir / f"dp_{label}.json").read_text())


def data_parallel(ctx, cli_dir):
    """Phase 16(c): data parallel on the one card, against the 1-process
    fp32 reference at the whole batch and the ranks' own arithmetic, the
    batch split DP_WORLD ways, taken in this one process."""
    pool8 = np.stack([MockImageDataset(256, length=BATCH, seed=0)[i]
                      for i in range(BATCH)])
    want_d, want_dg, want_g, want_gg = fp32_steps(
        QUICKSTART, QUICKSTART_D, pool8, ctx.dev.type)
    _, split_dg, _, split_gg = fp32_steps(
        QUICKSTART, QUICKSTART_D, pool8, ctx.dev.type, shards=DP_WORLD)
    want_grads = {f"{mod}.{n_}": g_ for mod, grads in (("D", want_dg),
                                                      ("G", want_gg))
                  for n_, g_ in grads.items()}
    split_grads = {f"D.{n_}": g_ for n_, g_ in split_dg.items()}
    split_grads.update({f"G.{n_}": g_ for n_, g_ in split_gg.items()})
    split_vs_one = {n_: rel_err(split_grads[n_], w_)
                    for n_, w_ in want_grads.items()}
    del split_dg, split_gg, want_dg, want_gg
    gc.collect()
    torch.cuda.empty_cache()

    dp_dir = REPO / "gigagan-models" / "chip_smoke_dp"
    shutil.rmtree(dp_dir, ignore_errors=True)
    dp_dir.mkdir(parents=True)
    dp2 = run_ranks(cli_dir, dp_dir, DP_WORLD, "gloo", ["fp32", "bf16"],
                    "gloo2")
    got = torch.load(dp_dir / "gloo2_fp32.pt", weights_only=True)
    loss_rel = {f"{s_}_{k_}": abs(got[s_][k_] - float(v)) / max(
        abs(float(v)), 1e-6)
        for s_, want in (("d", want_d), ("g", want_g))
        for k_, v in want.items()}
    got_grads = {f"{mod}.{n_}": g_ for mod in ("D", "G")
                 for n_, g_ in got[mod].items()}
    if set(got_grads) != set(want_grads):
        fail("data-parallel fp32: the gradient leaves differ")
    vs_split = {n_: rel_err(g_, split_grads[n_])
                for n_, g_ in got_grads.items()}
    vs_one = {n_: rel_err(g_, want_grads[n_]) for n_, g_ in got_grads.items()}
    limit = {n_: min(DP_GRAD_CAP, max(DP_GRAD_TOL,
                                      split_vs_one[n_] + DP_SPLIT_TOL))
             for n_ in vs_one}
    failing = {n_: dict(vs_one=vs_one[n_], limit=limit[n_],
                        vs_split=vs_split[n_])
               for n_ in vs_one
               if vs_one[n_] > limit[n_] or vs_split[n_] > DP_SPLIT_TOL}
    dists = dict(vs_one=vs_one, vs_split=vs_split, split_vs_one=split_vs_one)
    worst = {key: max(d_, key=d_.get) for key, d_ in dists.items()}
    dp = dict(loss_rel=loss_rel,
              worst={key: (n_, dists[key][n_]) for key, n_ in worst.items()},
              gloo2={k_: v for k_, v in dp2.items() if k_ != "losses"},
              gloo2_losses=dp2["losses"])
    log(f"data parallel fp32, 2 ranks x {BATCH // DP_WORLD} vs 1 process x "
        f"{BATCH}: losses max rel {max(loss_rel.values()):.2e} (limit "
        f"{DP_LOSS_TOL}); gradients over {len(vs_one)} leaves, max rel vs "
        f"the same {DP_WORLD}-way split in one process "
        f"{vs_split[worst['vs_split']]:.2e} at {worst['vs_split']} (limit "
        f"{DP_SPLIT_TOL}), vs one process "
        f"{vs_one[worst['vs_one']]:.2e} at {worst['vs_one']} (limit "
        f"{DP_GRAD_TOL}, or the split's own distance + {DP_SPLIT_TOL}, at "
        f"most {DP_GRAD_CAP}); the split in one process vs one process "
        f"{split_vs_one[worst['split_vs_one']]:.2e} at "
        f"{worst['split_vs_one']}")
    if max(loss_rel.values()) > DP_LOSS_TOL or failing:
        fail(f"data-parallel fp32 disagrees: {failing}, {loss_rel}")
    del got, got_grads, want_grads, split_grads
    dp1 = run_ranks(cli_dir, dp_dir, 1, "nccl", ["bf16"], "nccl1")
    dp["nccl1"] = dp1
    for label, res in (("gloo2", dp2), ("nccl1", dp1)):
        counts = res["launches_bf16"]
        finite = all(math.isfinite(v) for row in res["losses"]
                     for v in row.values())
        log(f"data parallel bf16 {label}: {DP_ITERATIONS} iterations, "
            f"unequal steps {res['unequal']}, launches "
            f"{routes_line(counts)}")
        if (not finite or res["unequal"] or on_cuda_cores(counts)
                or not all(counts[k_]["tc"] for k_ in
                           ("k1", "k2", "k3", "k4", "k5"))):
            fail(f"data parallel bf16 {label}: finite {finite}, unequal "
                 f"{res['unequal']}, launches {counts}")
    fp32_counts = dp2["launches_fp32"]
    if not all(fp32_counts[k_]["simt"] for k_ in ("k1", "k2", "k3", "k4",
                                                   "k5")):
        fail(f"data parallel fp32 launches: {fp32_counts}")
    shutil.rmtree(dp_dir, ignore_errors=True)
    return dp


def main():
    ctx = phase_1_card()
    ctx.phase_done("1")
    phase_2_build(ctx)
    ctx.phase_done("2")
    k1_shapes = phase_3_k1(ctx)
    ctx.phase_done("3")
    phase_4_k3(ctx)
    ctx.phase_done("4")
    phase_5_sampling(ctx, k1_shapes)
    ctx.phase_done("5")
    phase_18_sample_graph(ctx)
    ctx.phase_done("18")
    phase_6_k2(ctx)
    ctx.phase_done("6")
    phase_7_k4_k5(ctx)
    ctx.phase_done("7")
    phase_8_k6_k7(ctx)
    ctx.phase_done("8")
    phase_9_10_training(ctx, fwd_over_rev=False)
    ctx.phase_done("9")
    phase_9_10_training(ctx, fwd_over_rev=True)
    ctx.phase_done("10")
    det = phase_11_steps(ctx)
    ctx.phase_done("11")
    phase_17_d128(ctx, det)
    ctx.phase_done("17")
    phase_12_trainer(ctx)
    ctx.phase_done("12")
    phase_13_t2i(ctx)
    ctx.phase_done("13")
    phase_14_upsampler(ctx)
    ctx.phase_done("14")
    phase_16_surface(ctx)
    ctx.phase_done("16")
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(ctx.report, indent=1))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if "--deterministic-resume" in sys.argv[1:]:
        sys.exit(deterministic_resume())
    if sys.argv[1:2] == ["--cli-child"]:
        sys.exit(cli_child(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--dp-child"]:
        sys.exit(dp_child(json.loads(sys.argv[2])))
    main()
