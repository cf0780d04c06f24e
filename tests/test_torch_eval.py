"""The port's quality metrics (``gigagan_tpu_torch/eval.py``) against the
JAX package's (``gigagan_tpu/eval.py``): the cases of
``tests/test_eval.py``, each computed by both on the same embeddings and
held to 1e-6 relative, and the evaluator's CLIP embeddings against the
JAX adapter's with the same (random-init) weights, at the CLIP towers'
tolerance of ``tests/test_torch_clip.py``."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu import eval as jeval  # noqa: E402
from gigagan_tpu.models import clip as jclip  # noqa: E402

from gigagan_tpu_torch import eval as teval  # noqa: E402
from gigagan_tpu_torch.convert import convert_clip_params  # noqa: E402
from gigagan_tpu_torch.models import clip as tclip  # noqa: E402

TOL = 1e-6  # the same numerics on the same embeddings
TOWER_RTOL, TOWER_ATOL = 2e-4, 5e-5  # fp32 CLIP towers of two frameworks
TINY = dict(embed_dim=16, image_size=32, patch_size=8, vision_width=24,
            vision_layers=2, vision_heads=2, context_length=12,
            vocab_size=49408, text_width=16, text_layers=2, text_heads=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b):
    return abs(a - b) <= TOL * max(abs(b), 1e-12) or abs(a - b) <= 1e-12


# ------------------------------------------------------------ statistics


@pytest.mark.parametrize("n,d,seed", [(500, 8, 0), (40, 5, 1), (3, 6, 2)])
def test_gaussian_stats_match_jax(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d))
    for a, b in zip(teval.gaussian_stats(x), jeval.gaussian_stats(x)):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=1e-12)


def frechet_pair(*args):
    return teval.frechet_distance(*args), jeval.frechet_distance(*args)


def test_identical_gaussians_zero():
    x = np.random.default_rng(0).normal(size=(500, 8))
    mu, cov = teval.gaussian_stats(x)
    ours, theirs = frechet_pair(mu, cov, mu, cov)
    assert abs(ours) < 1e-8 and close(ours, theirs)


def test_analytic_diagonal_case():
    mu1, mu2 = np.array([0.0, 0.0]), np.array([1.0, -2.0])
    c1, c2 = np.diag([4.0, 9.0]), np.diag([1.0, 1.0])
    expected = (1.0 + 4.0) + (2.0 - 1.0) ** 2 + (3.0 - 1.0) ** 2
    ours, theirs = frechet_pair(mu1, c1, mu2, c2)
    np.testing.assert_allclose(ours, expected, rtol=1e-10)
    assert close(ours, theirs)


def test_mean_shift_monotone():
    base = np.random.default_rng(1).normal(size=(400, 6))
    mu, cov = teval.gaussian_stats(base)
    small = frechet_pair(mu, cov, mu + 0.1, cov)
    big = frechet_pair(mu, cov, mu + 1.0, cov)
    assert 0 < small[0] < big[0]
    assert close(*small) and close(*big)


def test_symmetry():
    rng = np.random.default_rng(2)
    a = teval.gaussian_stats(rng.normal(size=(300, 5)))
    b = teval.gaussian_stats(rng.normal(loc=0.5, scale=2.0, size=(300, 5)))
    ab, ba = frechet_pair(*a, *b), frechet_pair(*b, *a)
    np.testing.assert_allclose(ab[0], ba[0], rtol=1e-8)
    assert close(*ab) and close(*ba)


def test_singular_covariances_take_the_same_guards():
    # fewer samples than dimensions: singular covariances, where sqrtm's
    # result needs the jitter or the imaginary-part guard
    rng = np.random.default_rng(3)
    a = teval.gaussian_stats(rng.normal(size=(4, 12)))
    b = teval.gaussian_stats(rng.normal(size=(5, 12)))
    ours, theirs = frechet_pair(*a, *b)
    assert np.isfinite(ours) and close(ours, theirs)


@pytest.mark.parametrize("case", ["matched", "orthogonal", "negative",
                                  "random"])
def test_clip_score_matches_jax(case):
    rng = np.random.default_rng(3)
    if case == "matched":
        e = rng.normal(size=(10, 8))
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
        a, b, want = e, e, 100.0
    elif case == "orthogonal":
        a, b, want = np.eye(4)[:2], np.eye(4)[2:], 0.0
    elif case == "negative":
        a = np.array([[1.0, 0.0]])
        b, want = -a, 0.0
    else:
        a, b = (x / np.linalg.norm(x, axis=-1, keepdims=True)
                for x in rng.normal(size=(2, 16, 8)))
        want = None
    ours = teval.clip_score(a, b)
    assert close(ours, jeval.clip_score(a, b))
    if want is not None:
        assert ours == pytest.approx(want)
    # a tensor input gives the same score
    assert close(teval.clip_score(torch.from_numpy(a), b), ours)


# ------------------------------------------------------------- evaluator


@pytest.fixture(scope="module")
def evaluators():
    """(JAX evaluator, port evaluator) over the JAX adapter's random-init
    CLIP, its parameters moved into the port's."""
    jax_adapter = jclip.OpenClipAdapter(name=jclip.CLIPConfig(**TINY),
                                        seed=0)
    port = tclip.OpenClipAdapter(name=tclip.CLIPConfig(**TINY), seed=0,
                                 device="cpu")
    port.model.load_state_dict(convert_clip_params(
        jax.device_get(jax_adapter.params), port.model))
    return (jeval.QualityEvaluator(jax_adapter, batch_size=4),
            teval.QualityEvaluator(port, batch_size=4))


def test_mock_reasons_surface(evaluators):
    jev, tev = evaluators
    assert not tev.is_real and not jev.is_real
    assert any("random-init" in r for r in tev.mock_reasons)
    assert len(tev.mock_reasons) == len(jev.mock_reasons)


def test_embed_images_match_jax(evaluators):
    jev, tev = evaluators
    imgs = np.random.default_rng(4).random((6, 32, 32, 3), dtype=np.float32)
    ours = tev.embed_images(imgs)
    assert ours.shape == (6, TINY["embed_dim"]) and ours.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0,
                               atol=1e-4)
    np.testing.assert_allclose(ours, jev.embed_images(imgs),
                               rtol=TOWER_RTOL, atol=TOWER_ATOL)
    # a tensor batch gives the same embeds
    np.testing.assert_allclose(tev.embed_images(torch.from_numpy(imgs)),
                               ours, rtol=0, atol=0)


def test_clip_fid_separates_distributions_as_jax(evaluators):
    _, tev = evaluators
    rng = np.random.default_rng(5)
    real = rng.random((12, 32, 32, 3), dtype=np.float32)
    same = np.clip(real + rng.normal(0, 0.01, real.shape), 0, 1).astype(
        np.float32)
    diff = np.zeros_like(real) + np.linspace(
        0, 1, 12, dtype=np.float32).reshape(-1, 1, 1, 1)
    r_same, r_diff = tev.clip_fid(real, same), tev.clip_fid(real, diff)
    assert r_same["clip_fid"] < r_diff["clip_fid"]
    assert r_same["n_real"] == r_same["n_fake"] == 12
    assert r_same["clip_is_real"] is False and r_same["mock_reasons"]
    # JAX's numerics on the port's embeddings
    for fakes, result in ((same, r_same), (diff, r_diff)):
        want = jeval.frechet_distance(
            *jeval.gaussian_stats(tev.embed_images(real)),
            *jeval.gaussian_stats(tev.embed_images(fakes)))
        assert close(result["clip_fid"], want)
    jev, _ = evaluators
    assert set(r_same) == set(jev.clip_fid(real, same))


def test_clip_score_end_to_end(evaluators):
    jev, tev = evaluators
    imgs = np.random.default_rng(6).random((3, 32, 32, 3), dtype=np.float32)
    texts = ["a", "b", "c"]
    out = tev.clip_score(imgs, texts=texts)
    assert 0.0 <= out["clip_score"] <= 100.0
    assert out["clip_is_real"] is False
    text_embeds, _ = tev.clip.embed_texts(texts)
    want = jeval.clip_score(tev.embed_images(imgs),
                            text_embeds.detach().numpy())
    assert close(out["clip_score"], want)
    assert set(out) == set(jev.clip_score(imgs, texts=texts))
