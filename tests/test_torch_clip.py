"""The port's CLIP, tokenizers and adapter against the JAX package's on the
CPU, at the tiny config of tests/test_clip.py: the flax CLIP's parameters
go through the weight bridge (``convert_clip_params``) into the port's
open_clip-named modules; an open_clip-style torch state dict loads into
both; the tokenizers give the same ids."""

import gzip
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu.losses import clip_contrastive_loss as jax_contrastive  # noqa: E402,E501
from gigagan_tpu.models import clip as jclip  # noqa: E402

from gigagan_tpu_torch.convert import convert_clip_params  # noqa: E402
from gigagan_tpu_torch.losses import clip_contrastive_loss  # noqa: E402
from gigagan_tpu_torch.models import clip as tclip  # noqa: E402

TINY = dict(embed_dim=16, image_size=32, patch_size=8, vision_width=24,
            vision_layers=2, vision_heads=2, context_length=12,
            vocab_size=49408, text_width=16, text_layers=2, text_heads=2)
# fp32 towers of two frameworks: the tolerance tests/test_clip.py holds the
# flax towers to against a torch transcription of open_clip
RTOL, ATOL = 2e-4, 5e-5


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def adapters():
    """(JAX adapter, port adapter) with the JAX adapter's random-init
    parameters in both."""
    jax_adapter = jclip.OpenClipAdapter(name=jclip.CLIPConfig(**TINY),
                                        seed=0)
    port = tclip.OpenClipAdapter(name=tclip.CLIPConfig(**TINY), seed=0,
                                 device="cpu")
    port.model.load_state_dict(convert_clip_params(
        jax.device_get(jax_adapter.params), port.model))
    return jax_adapter, port


IDS = np.zeros((3, 12), np.int64)
IDS[0, :4] = [jclip.SOT_ID, 11, 23, jclip.EOT_ID]
IDS[1, :6] = [jclip.SOT_ID, 100, 200, 300, 400, jclip.EOT_ID]
IDS[2, :3] = [jclip.SOT_ID, 5, jclip.EOT_ID]
IMAGES = np.random.default_rng(7).uniform(size=(3, 32, 32, 3)).astype(
    np.float32)


def jax_towers(model, params, images, ids):
    img, taps = model.apply({"params": params}, jnp.asarray(images),
                            method=jclip.CLIPModel.encode_image)
    txt, enc = model.apply({"params": params}, jnp.asarray(ids, jnp.int32),
                           method=jclip.CLIPModel.encode_text)
    return [np.asarray(a) for a in (img, taps, txt, enc)]


def port_towers(model, images, ids):
    with torch.no_grad():
        img, taps = model.encode_image(t(images))
        txt, enc = model.encode_text(t(ids))
    return [a.numpy() for a in (img, taps, txt, enc)]


def check_towers(got, want):
    names = ("image embed", "visual taps", "text embed", "token encodings")
    for g, w, name in zip(got, want, names):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


def test_towers_and_taps_match_flax(adapters):
    jax_adapter, port = adapters
    want = jax_towers(jax_adapter.model, jax_adapter.params, IMAGES, IDS)
    got = port_towers(port.model, IMAGES, IDS)
    assert got[1].shape == (2, 3, 17, 24)  # (L, b, 1 + (32/8)², width)
    check_towers(got, want)


def open_clip_state_dict(seed):
    """A state dict with open_clip's names and layouts at the tiny config,
    from the torch transcription of open_clip in tests/test_clip.py."""
    import test_clip

    _, model = test_clip.TestCLIPGoldenParity._build_torch_clip(
        jclip.CLIPConfig(**TINY), seed=seed)
    return model, {k: v.detach().clone() for k, v in
                   model.state_dict().items()}


def test_open_clip_state_dict_loads_as_in_jax(tmp_path):
    # the same open_clip state dict: loaded into the port as it is, mapped
    # into flax by the JAX package, and run by the torch transcription
    reference, sd = open_clip_state_dict(seed=3)
    model = tclip.CLIPModel(tclip.CLIPConfig(**TINY))
    tclip.load_open_clip_state_dict(model, sd)
    params = jax.tree.map(jnp.asarray, jclip.map_open_clip_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jclip.CLIPConfig(**TINY)))
    want = jax_towers(jclip.CLIPModel(jclip.CLIPConfig(**TINY)), params,
                      IMAGES, IDS)
    got = port_towers(model, IMAGES, IDS)
    check_towers(got, want)
    with torch.no_grad():
        ref_img, ref_taps = reference.encode_image(
            t(IMAGES).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got[0], ref_img.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got[1][-1], ref_taps[-1].numpy(), rtol=RTOL,
                               atol=ATOL)

    # from disk, through the adapter: a file of tensors, loaded with
    # weights_only; a name without a hash passes the checksum step
    path = tmp_path / "tiny-clip.pt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    adapter = tclip.OpenClipAdapter(name=tclip.CLIPConfig(**TINY),
                                    pretrained=str(path), device="cpu")
    assert adapter.has_pretrained_weights
    check_towers(port_towers(adapter.model, IMAGES, IDS), want)
    assert not any(p.requires_grad for p in adapter.model.parameters())
    # a state dict that lacks a parameter fails loudly
    del sd["visual.proj"]
    with pytest.raises(KeyError, match="visual.proj"):
        tclip.load_open_clip_state_dict(model, sd)


TEXTS = ["a cat", "A Dog &amp; a cat, on the mat!!", "", "it's  red\tblue",
         "a very long caption that keeps going " * 4]


def test_hash_tokenizer_matches_jax():
    for n in (12, 77):
        got = tclip.HashTokenizer(context_length=n)(TEXTS)
        np.testing.assert_array_equal(
            got, jclip.HashTokenizer(context_length=n)(TEXTS))


def test_simple_tokenizer_matches_jax(tmp_path):
    merges = ["t h", "th e</w>", "c a", "ca t</w>", "a t</w>", "m at</w>",
              "r e", "re d</w>", "o n</w>", "d o", "do g</w>", "' s</w>",
              "! !</w>", "k e", "ke e"]
    path = tmp_path / "bpe_tiny.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: tiny", *merges]) + "\n")
    for n in (12, 77):
        got = tclip.SimpleTokenizer(str(path), context_length=n)(TEXTS)
        want = jclip.SimpleTokenizer(str(path), context_length=n)(TEXTS)
        np.testing.assert_array_equal(got, want)
    # the merges were used, and a long caption ends on the EOT id
    assert got.max() > 512 and got[4, -1] == tclip.EOT_ID


def test_text_mask_from_ids_matches_jax():
    ids = np.array([[jclip.SOT_ID, 5, 9, jclip.EOT_ID, 0, 0],
                    [jclip.SOT_ID, 5, jclip.EOT_ID, 7, jclip.EOT_ID, 0]])
    np.testing.assert_array_equal(
        tclip.OpenClipAdapter.text_mask_from_ids(t(ids)).numpy(),
        np.asarray(jclip.OpenClipAdapter.text_mask_from_ids(
            jnp.asarray(ids))))


def test_adapter_embeddings_match_jax(adapters):
    jax_adapter, port = adapters
    texts = ["a cat", "a dog on a mat", "red"]
    embed, enc = port.embed_texts(texts)
    j_embed, j_enc = jax_adapter.embed_texts(texts)
    np.testing.assert_allclose(embed.numpy(), j_embed, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(enc.numpy(), j_enc, rtol=RTOL, atol=ATOL)
    # zero past EOS ('a cat' = sot + 2 + eot), the rest not
    assert not enc[0, 4:].any() and enc[0, :4].abs().sum(-1).all()
    assert embed.dtype == enc.dtype == torch.float32

    # 64px images: the nearest resize to CLIP's 32px, then normalised
    images = np.random.default_rng(8).uniform(size=(3, 64, 64, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        port.normalize_images(t(images)).numpy(),
        jax_adapter.normalize_images(jnp.asarray(images)), rtol=1e-6,
        atol=1e-6)
    img, taps = port.embed_images(t(images))
    j_img, j_taps = jax_adapter.embed_images(jnp.asarray(images))
    np.testing.assert_allclose(img.numpy(), j_img, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(taps.numpy(), j_taps, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(img.numpy(), axis=-1), 1.0,
                               rtol=1e-5)

    np.testing.assert_allclose(port.logit_scale, jax_adapter.logit_scale,
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(port.contrastive_loss(t(images), texts=texts)),
        float(jax_adapter.contrastive_loss(jnp.asarray(images),
                                           texts=texts)), rtol=1e-4)
    # the loss alone, on unrelated unit vectors and a scale of 7
    rng = np.random.default_rng(9)
    a, b = (rng.standard_normal((5, 16)).astype(np.float32)
            for _ in range(2))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    np.testing.assert_allclose(float(clip_contrastive_loss(t(a), t(b), 7.0)),
                               float(jax_contrastive(a, b, 7.0)), rtol=1e-5)
    for attr in ("dim_latent", "image_size", "image_channels",
                 "max_text_len"):
        assert getattr(port, attr) == getattr(jax_adapter, attr), attr
    assert port.dim_image_latent == jax_adapter._dim_image_latent


def test_images_get_gradients_through_the_frozen_clip(adapters):
    _, port = adapters
    images = t(IMAGES).requires_grad_()
    embed, taps = port.embed_images(images)
    (embed.sum() + taps.sum()).backward()
    assert images.grad.abs().sum() > 0
    assert all(p.grad is None for p in port.model.parameters())


def test_checksum_helpers_and_mock_reasons_match_jax(tmp_path, adapters):
    p = tmp_path / "weights.pt"
    p.write_bytes(b"not really a checkpoint")
    digest = tclip.file_sha256(p)
    assert digest == jclip.file_sha256(p)
    assert tclip.verify_checkpoint_checksum(p, digest[:8]) == digest
    with pytest.raises(ValueError, match="sha256 mismatch"):
        tclip.verify_checkpoint_checksum(p, "deadbeef")
    # open_clip's release names carry sha256[:8]: a wrong file under such a
    # name fails with no expectation passed; an anonymous name passes
    bad = tmp_path / "vit_b_32-laion400m_e32-46683a32.pt"
    bad.write_bytes(b"wrong contents")
    with pytest.raises(ValueError, match="sha256 mismatch"):
        tclip.verify_checkpoint_checksum(bad)
    assert tclip.KNOWN_SHA256_PREFIXES == jclip.KNOWN_SHA256_PREFIXES

    jax_adapter, port = adapters
    assert port.mock_reasons == jax_adapter.mock_reasons
    assert len(port.mock_reasons) == 2 and port.uses_hash_tokenizer


def test_a_pickled_checkpoint_loads_only_when_pinned(tmp_path):
    # a pickled module needs a full unpickle, which can run code from the
    # file: refused unless the file's sha256 matched a pin
    model = tclip.CLIPModel(tclip.CLIPConfig(**TINY))
    model.reset_parameters(torch.Generator().manual_seed(2))
    path = tmp_path / "tiny-clip-module.pt"
    torch.save(model, path)
    with pytest.raises(pickle.UnpicklingError, match="full unpickle"):
        tclip.load_open_clip_torch_checkpoint(path)
    with pytest.raises(pickle.UnpicklingError, match="full unpickle"):
        tclip.OpenClipAdapter(name=tclip.CLIPConfig(**TINY),
                              pretrained=str(path), device="cpu")
    with pytest.raises(pickle.UnpicklingError, match="full unpickle"):
        tclip.OpenClipAdapter(name=tclip.CLIPConfig(**TINY),
                              pretrained=str(path), verify_checksum=False,
                              device="cpu")
    digest = tclip.file_sha256(path)
    adapter = tclip.OpenClipAdapter(name=tclip.CLIPConfig(**TINY),
                                    pretrained=str(path),
                                    expected_sha256=digest[:8], device="cpu")
    for key, want in model.state_dict().items():
        assert torch.equal(adapter.model.state_dict()[key], want), key


def test_port_init_has_the_jax_distributions(adapters):
    # the port's own random init: per leaf the scale of flax's
    jax_adapter, _ = adapters
    port = tclip.OpenClipAdapter(name=tclip.CLIPConfig(**TINY), seed=1,
                                 device="cpu")
    want = convert_clip_params(jax.device_get(jax_adapter.params),
                               port.model)
    got = port.model.state_dict()
    for key, w in want.items():
        g = got[key]
        if w.numel() == 1 or float(w.std()) == 0.0:  # constants
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       err_msg=key)
        elif w.numel() >= 200:
            ratio = float(g.std() / w.std())
            assert 0.8 < ratio < 1.25, (key, ratio)


def test_adapter_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tclip.OpenClipAdapter(name=tclip.CLIPConfig(**TINY))
