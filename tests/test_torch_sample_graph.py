"""``GigaGAN.generate``'s G forward as a CUDA graph
(``gigagan_tpu_torch/train/sample_graph.py``) and the blur filters it
needed kept on the device (``ops/resample.py``).

On the CPU: the kept filters are bitwise the per-call construction they
replace and serve a backward after being made in inference mode; the
engage and key rule; the bound on a module's graphs; ``generate`` on the
CPU never captures and returns the eager forward's pixels.  Marked
``cuda`` (skipped without a card; run there with ``python -m pytest
--noconftest -m cuda tests/test_torch_sample_graph.py``): replayed
``generate`` bitwise equal to the eager forward for the quickstart G and a
small text-conditioned G at batch 1 and 4, replays after in-place weight
updates and after ``load``, and a capture under
``torch.cuda.set_sync_debug_mode("error")``.  This file imports no JAX."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu_torch import GigaGAN  # noqa: E402
from gigagan_tpu_torch.ops import resample  # noqa: E402
from gigagan_tpu_torch.ops.kernels import plain_reference  # noqa: E402
from gigagan_tpu_torch.train import sample_graph  # noqa: E402

G_CFG = dict(image_size=16, dim_capacity=4, dim_max=32, dim_latent=16,
             style_network=dict(dim=16, depth=1), self_attn_resolutions=(8,),
             num_conv_kernels=2, num_skip_layers_excite=1,
             unconditional=True)
# the README quickstart's G (chip_smoke.py's QUICKSTART)
QUICKSTART = dict(image_size=256, dim_capacity=8, dim_max=512,
                  dim_latent=512, style_network=dict(dim=64, depth=4),
                  num_skip_layers_excite=4, unconditional=True)
CLIP_DIM = 64
G_TEXT = dict(image_size=64, dim_capacity=8, dim_max=128, dim_latent=128,
              style_network=dict(dim=64, depth=2, dim_text_latent=64),
              text_encoder=dict(dim=64, depth=1, clip_dim=CLIP_DIM),
              self_attn_resolutions=(16,), cross_attn_resolutions=(16,),
              num_skip_layers_excite=2, unconditional=False)
INPUTS = dict(styles=None, noise=None, text_encodings=None)


def todays_filter(kind, device, dtype):
    """The blur filter as each blur built it before it was kept."""
    f = torch.tensor((1.0, 2.0, 1.0), dtype=torch.float32, device=device)
    if kind == "2d":
        f = f[:, None] * f[None, :]
    elif kind == "3d":
        f = f[:, None, None] * f[None, :, None] * f[None, None, :]
    else:
        f = f[:, None, None].expand(3, 3, 3)
    return (f / f.sum()).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["2d", "3d", "temporal"])
def test_kept_blur_filter_is_bitwise_todays(kind, dtype):
    got = resample._blur_filter(kind, torch.device("cpu"), dtype)
    want = todays_filter(kind, "cpu", dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert not got.is_inference()
    # every blur reads the kept filter: the same result as today's conv
    shape = (2, 5, 6, 3) if kind == "2d" else (2, 4, 5, 6, 3)
    blur = {"2d": resample.blur_2d, "3d": resample.blur_3d,
            "temporal": resample.blur_temporal}[kind]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)
                    ).to(dtype)
    assert torch.equal(blur(x), resample._depthwise(x, want))


def test_filter_made_in_inference_mode_serves_a_backward():
    resample._blur_filter.cache_clear()
    x = torch.randn(1, 6, 6, 2, dtype=torch.float64)
    with torch.inference_mode():
        resample.upsample_2x_blur(x)
    x.requires_grad_(True)
    resample.blur_2d(x).square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("case", ["cpu", "upsampler", "plain", "cuda"])
def test_graph_key_engages_on_cuda_only(case):
    device = "cpu" if case == "cpu" else torch.device("cuda", 0)
    upsampler = case == "upsampler"
    if case == "plain":
        with plain_reference():
            key = sample_graph.graph_key(device, False, 1, torch.bfloat16,
                                         INPUTS)
    else:
        key = sample_graph.graph_key(device, upsampler, 1, torch.bfloat16,
                                     INPUTS)
    assert (key is not None) == (case == "cuda")


def test_graph_key_tells_shapes_and_dtypes_apart():
    dev = torch.device("cuda", 0)

    def key(b=1, dtype=torch.bfloat16, **given):
        return sample_graph.graph_key(dev, False, b, dtype,
                                      dict(INPUTS, **given))

    text = lambda *shape: torch.zeros(shape)  # noqa: E731
    keys = [key(), key(b=4), key(dtype=torch.float32),
            key(text_encodings=text(1, 8, 16)),
            key(text_encodings=text(1, 12, 16)),
            key(text_encodings=text(2, 8, 16)),
            key(text_encodings=text(1, 8, 16).bfloat16()),
            key(styles=text(1, 16)), key(noise=text(1, 16))]
    assert len(set(keys)) == len(keys)
    assert key(text_encodings=text(1, 8, 16)) == key(
        text_encodings=torch.ones(1, 8, 16))


def test_graphs_evict_the_least_recently_used():
    graphs = sample_graph.Graphs(limit=3)
    for k in "abc":
        graphs.put(k, k.upper())
    assert graphs.get("a") == "A"  # now the most recent
    graphs.put("d", "D")
    assert list(graphs.entries) == ["c", "a", "d"]
    assert graphs.get("b") is None
    graphs.put("c", sample_graph.WARM)
    graphs.put("e", "E")
    assert list(graphs.entries) == ["d", "c", "e"]
    assert len(graphs.entries) == graphs.limit


def test_a_copy_of_a_module_holds_no_graphs():
    module = torch.nn.Linear(2, 2)
    graphs = sample_graph.graphs_of(module)
    graphs.put("k", "captured")
    assert sample_graph.graphs_of(module) is graphs
    twin = copy.deepcopy(module)
    assert sample_graph.graphs_of(twin).entries == {}
    assert graphs.entries == {"k": "captured"}


def eager_images(gan, g, batch_size, seed, **inputs):
    """G's forward as generate ran it before graphs: fresh generators seeded
    from ``SeedSequence(seed)``, then the readback."""
    seeds = tuple(map(int, np.random.SeedSequence(seed).generate_state(2)))
    with torch.inference_mode():
        out = g(**inputs, batch_size=batch_size,
                noise_generator=torch.Generator(device=gan.device)
                .manual_seed(seeds[0]),
                latent_generator=torch.Generator(device=gan.device)
                .manual_seed(seeds[1]))
    return out.float().cpu().numpy()


@pytest.mark.parametrize("amp", [True, False])
def test_cpu_generate_never_captures(amp):
    gan = GigaGAN(generator=G_CFG, device="cpu", seed=0, amp=amp)
    styles = torch.randn(2, 16, generator=torch.Generator().manual_seed(1))
    for _ in range(3):  # a key's second call would capture on the card
        for b, seed in ((1, 0), (3, 5), (2, 2 ** 40)):
            got = gan.generate(batch_size=b, seed=seed)
            assert np.array_equal(got, eager_images(gan, gan.G_ema, b, seed))
        got = gan.generate(styles=styles, seed=7, use_ema=False)
        assert np.array_equal(got, eager_images(gan, gan.G, 2, 7,
                                                styles=styles))
    for g in (gan.G, gan.G_ema):
        assert "_sample_graphs" not in g.__dict__


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with --noconftest "
                    "-m cuda)")
    return torch.device("cuda", 0)


def make(cfg, seed=0):
    return GigaGAN(generator=cfg, amp=True, device="cuda", seed=seed)


def text_encodings(b, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, 16, CLIP_DIM, generator=g)


def captured(gan):
    return [e for e in sample_graph.graphs_of(gan.G_ema).entries.values()
            if isinstance(e, sample_graph.Captured)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("cfg", ["quickstart", "text"])
def test_replay_is_bitwise_the_eager_forward(card, cfg, batch):
    gan = make(QUICKSTART if cfg == "quickstart" else G_TEXT)
    for i, seed in enumerate((0, 1234567, 2 ** 62 + 9)):
        kwargs = {}
        if cfg == "text":
            kwargs["text_encodings"] = text_encodings(batch, i)
        want = eager_images(gan, gan.G_ema, batch, seed,
                            **{k: v.to(card) for k, v in kwargs.items()})
        # the first call runs eagerly, the second captures and replays
        for _ in range(2 if i == 0 else 1):
            got = gan.generate(batch_size=batch, seed=seed, **kwargs)
        assert len(captured(gan)) == 1
        assert np.array_equal(got, want), (cfg, batch, seed)


@pytest.mark.cuda
def test_replay_follows_weights_updated_in_place_and_loaded(card, tmp_path):
    gan = make(QUICKSTART)
    for _ in range(2):
        before = gan.generate(batch_size=1, seed=3)
    assert len(captured(gan)) == 1
    with torch.no_grad():
        for p in gan.G_ema.parameters():
            p.mul_(0.5)
    got = gan.generate(batch_size=1, seed=3)
    assert not np.array_equal(got, before)
    assert np.array_equal(got, eager_images(gan, gan.G_ema, 1, 3))
    other = make(QUICKSTART, seed=1)
    other.save(tmp_path / "other.ckpt")
    want = other.generate(batch_size=1, seed=3)
    gan.load(tmp_path / "other.ckpt")
    assert len(captured(gan)) == 1
    got = gan.generate(batch_size=1, seed=3)
    assert np.array_equal(got, want)
    assert np.array_equal(got, eager_images(gan, gan.G_ema, 1, 3))


@pytest.mark.cuda
def test_capture_makes_no_sync(card):
    gan = make(QUICKSTART)
    g = gan.G_ema
    inputs = dict(INPUTS)
    gan.generate(batch_size=1, seed=0)  # the eager warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            graph = sample_graph.Captured(g, card, 1, inputs)
            out = graph.replay((11, 12), inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with torch.inference_mode():
        want = g(batch_size=1,
                 noise_generator=torch.Generator(card).manual_seed(11),
                 latent_generator=torch.Generator(card).manual_seed(12))
    assert torch.equal(out, want)
