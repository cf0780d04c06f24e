"""CLIP (ViT-B/32 by default) with the visual tower's per-layer taps, the
tokenizers and the reference-API adapter (counterpart of
gigagan_tpu/models/clip.py).

- ``CLIPModel`` holds open_clip's parameter names
  (``transformer.resblocks.i.attn.in_proj_weight``, ``visual.conv1.weight``,
  ...), so an open_clip ``state_dict`` loads with ``load_state_dict`` and
  no mapping.  Attention in the towers is plain math (77 text tokens, 50
  image tokens), as JAX runs flax's attention there.
- ``SimpleTokenizer`` (CLIP's BPE, from the merges file on disk) and
  ``HashTokenizer`` (a deterministic stand-in with the same (sot, …, eot,
  pad) contract), standard library only.
- ``OpenClipAdapter``: ``embed_texts`` (l2-normed embed, token encodings
  zero-masked past EOS), ``embed_images`` (l2-normed embed, (L, b, 1+n, d)
  visual taps) and ``contrastive_loss``.  Its parameters are frozen
  (``requires_grad_(False)``), live outside every trainable module and
  optimizer and stay float32 under amp.
"""

from __future__ import annotations

import gzip
import hashlib
import html
import math
import pickle
import re
from collections import OrderedDict
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gigagan_tpu_torch import ops
from gigagan_tpu_torch.utils import exists, span

OPENAI_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # vision
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    quick_gelu: bool = True


VIT_B_32 = CLIPConfig()

CONFIGS = {
    "ViT-B/32": VIT_B_32,
    "ViT-B-32": VIT_B_32,
    "ViT-B/16": CLIPConfig(patch_size=16),
    "ViT-L/14": CLIPConfig(
        embed_dim=768, patch_size=14, vision_width=1024, vision_layers=24,
        vision_heads=16, text_width=768, text_layers=12, text_heads=12,
    ),
}


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x):
        return quick_gelu(x)


class _Attention(nn.Module):
    """Multi-head self-attention with ``nn.MultiheadAttention``'s parameter
    names (packed ``in_proj_weight``/``in_proj_bias``, ``out_proj``), on
    (b, n, w), with an optional additive (n, n) mask."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, mask=None):
        b, n, w = x.shape
        d = w // self.heads
        q, k, v = F.linear(x, self.in_proj_weight,
                           self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, self.heads, d).transpose(1, 2)
                   for t in (q, k, v))
        sim = (q * d ** -0.5) @ k.transpose(-1, -2)
        if exists(mask):
            sim = sim + mask
        out = sim.softmax(dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, n, w))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then x + mlp(ln_2(x))."""

    def __init__(self, width: int, heads: int, quick_gelu_act: bool = True):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, width * 4)),
            ("gelu", QuickGELU() if quick_gelu_act else nn.GELU()),
            ("c_proj", nn.Linear(width * 4, width)),
        ]))

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 quick_gelu_act: bool = True):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, quick_gelu_act)
            for _ in range(layers))


class CLIPVisionTower(nn.Module):
    """Patch conv, class token, ``ln_pre``, the resblocks (each output is a
    tap), ``ln_post`` of the class token and ``proj``."""

    def __init__(self, cfg: CLIPConfig = VIT_B_32):
        super().__init__()
        w, p = cfg.vision_width, cfg.patch_size
        self.conv1 = nn.Conv2d(3, w, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(
            torch.empty(1 + (cfg.image_size // p) ** 2, w))
        self.ln_pre = nn.LayerNorm(w, eps=1e-5)
        self.transformer = _Transformer(w, cfg.vision_layers,
                                        cfg.vision_heads, cfg.quick_gelu)
        self.ln_post = nn.LayerNorm(w, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, images):
        """images (b, H, W, 3), resized and CLIP-normalised → (embed (b,
        embed_dim), taps (L, b, 1+n, width))."""
        x = self.conv1(images.permute(0, 3, 1, 2))
        b, w = x.shape[:2]
        x = x.reshape(b, w, -1).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, w)
        x = torch.cat((cls, x), dim=1)
        x = self.ln_pre(x + self.positional_embedding[:x.shape[1]])
        taps = []
        for block in self.transformer.resblocks:
            x = block(x)
            taps.append(x)
        return self.ln_post(x[:, 0]) @ self.proj, torch.stack(taps)


class CLIPTextTower(nn.Module):
    """Token and position embedding, causal resblocks, ``ln_final``; the
    pooled feature is the encoding at the EOS position (the highest token
    id, open_clip's convention) times ``text_projection``.  Its parameters
    sit at the top level of ``CLIPModel``, where open_clip keeps them."""

    def __init__(self, cfg: CLIPConfig = VIT_B_32):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.text_width))
        self.transformer = _Transformer(cfg.text_width, cfg.text_layers,
                                        cfg.text_heads, cfg.quick_gelu)
        self.ln_final = nn.LayerNorm(cfg.text_width, eps=1e-5)
        self.text_projection = nn.Parameter(
            torch.empty(cfg.text_width, cfg.embed_dim))

    def encode_text(self, ids):
        """ids (b, n) → (embed (b, embed_dim), encodings (b, n, width))."""
        n = ids.shape[1]
        x = self.token_embedding(ids) + self.positional_embedding[:n]
        causal = torch.full((n, n), float("-inf"), device=ids.device).triu(1)
        for block in self.transformer.resblocks:
            x = block(x, causal)
        encodings = self.ln_final(x)
        pooled = encodings[torch.arange(ids.shape[0], device=ids.device),
                           ids.argmax(dim=-1)]
        return pooled @ self.text_projection, encodings


class CLIPModel(CLIPTextTower):
    """The text tower's parameters at the top level, the vision tower under
    ``visual`` and ``logit_scale``: open_clip's ``CLIP`` layout."""

    def __init__(self, cfg: CLIPConfig = VIT_B_32):
        super().__init__(cfg)
        self.config = cfg
        self.visual = CLIPVisionTower(cfg)
        self.logit_scale = nn.Parameter(torch.empty(()))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX package's initial distributions: LayerNorm 1 and 0,
        Dense, attention and patch kernels lecun-normal, biases 0, the
        token embedding N(0, 1/width), the text positions N(0, 0.01²), the
        class token, image positions and projections N(0, 1/width),
        logit_scale log(1/0.07)."""
        cfg = self.config

        def normal(p, std):
            p.normal_(0.0, std, generator=generator)

        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith("visual.") and leaf in (
                    "class_embedding", "positional_embedding", "proj"):
                normal(p, cfg.vision_width ** -0.5)
            elif name == "positional_embedding":
                normal(p, 0.01)
            elif name == "text_projection":
                normal(p, cfg.text_width ** -0.5)
            elif name == "token_embedding.weight":
                normal(p, cfg.text_width ** -0.5)
            elif name == "logit_scale":
                p.fill_(math.log(1 / 0.07))
            elif ".ln_" in name or name.startswith(("ln_", "visual.ln_")):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf.endswith("bias"):
                p.zero_()
            else:  # (out, in, ...) kernels: fan_in over all but dim 0
                normal(p, (p[0].numel()) ** -0.5)

    def encode_image(self, images):
        return self.visual(images)


# --------------------------------------------------------------- tokenizers

SOT_ID = 49406
EOT_ID = 49407


@lru_cache()
def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text):
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text):
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """CLIP's BPE tokenizer; needs the bpe_simple_vocab_16e6.txt(.gz)
    merges file on disk."""

    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = _bytes_to_unicode()
        path = Path(bpe_path)
        raw = (
            gzip.open(path, "rt", encoding="utf-8").read()
            if path.suffix == ".gz"
            else path.read_text(encoding="utf-8")
        )
        merges = raw.split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(_bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[^\s\w]+|\w+",
            re.IGNORECASE,
        )

    def _bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def __call__(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.context_length), np.int32)
        for row, text in enumerate(texts):
            text = _whitespace_clean(_basic_clean(text)).lower()
            ids = [SOT_ID]
            for token in re.findall(self.pat, text):
                token = "".join(
                    self.byte_encoder[b] for b in token.encode("utf-8")
                )
                ids.extend(
                    self.encoder[t] for t in self._bpe(token).split(" ")
                )
            ids.append(EOT_ID)
            ids = ids[: self.context_length]
            ids[-1] = EOT_ID if len(ids) == self.context_length else ids[-1]
            out[row, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic offline stand-in: word → stable-hash id.  Keeps the
    (sot, ..., eot, pad) contract so the masking downstream works; NOT
    CLIP's vocabulary — use SimpleTokenizer with the BPE file for real
    text conditioning."""

    def __init__(self, context_length: int = 77,
                 vocab_size: int = 49408):
        self.context_length = context_length
        self.vocab_size = vocab_size

    def _word_id(self, word: str) -> int:
        h = int(hashlib.md5(word.encode()).hexdigest(), 16)
        return 1 + h % (self.vocab_size - 3)

    def __call__(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.context_length), np.int32)
        for row, text in enumerate(texts):
            words = re.findall(r"\w+", text.lower())
            ids = [SOT_ID, *map(self._word_id, words)]
            ids = ids[: self.context_length - 1]
            ids.append(EOT_ID)
            out[row, : len(ids)] = ids
        return out


# ------------------------------------------------------------- checkpoints

# sha256 prefixes of the reference's pretrained assets, for verifying a
# file dropped in by hand.  open_clip's release filenames embed the first 8
# hex characters of the file's sha256, e.g. vit_b_32-laion400m_e32-46683a32.pt
KNOWN_SHA256_PREFIXES = {
    ("ViT-B/32", "laion400m_e32"): "46683a32",
}


def file_sha256(path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(chunk), b""):
            h.update(blk)
    return h.hexdigest()


def checksum_pin(path, expected: Optional[str] = None) -> Optional[str]:
    """The sha256 prefix a checkpoint file is held to: ``expected``, else
    the one open_clip's release filename ``*-<sha256[:8]>.pt`` carries,
    else None (no pin)."""
    if expected is None:
        m = re.search(r"-([0-9a-f]{8,64})\.(?:pt|bin|pth)$",
                      Path(str(path)).name)
        expected = m.group(1) if m else None
    return expected


def verify_checkpoint_checksum(path, expected: Optional[str] = None):
    """Checksum-verify a CLIP checkpoint file.

    ``expected`` is a sha256 prefix (>= 8 hex characters).  Without it, it
    is recovered from open_clip's release filename convention
    ``*-<sha256[:8]>.pt`` where the file follows it; a file with no
    recoverable expectation passes (the hash is still computed and
    returned, so that callers can pin it).  Raises ValueError on a
    mismatch."""
    path = Path(str(path))
    actual = file_sha256(path)
    expected = checksum_pin(path, expected)
    if expected is not None and not actual.startswith(expected.lower()):
        raise ValueError(
            f"CLIP checkpoint {path} sha256 mismatch: expected prefix "
            f"{expected!r}, file hashes to {actual[:16]}…  (corrupt "
            "download or wrong file)"
        )
    return actual


def load_open_clip_torch_checkpoint(path, allow_pickle: bool = False) -> dict:
    """An open_clip checkpoint on disk → its state_dict (float32 CPU
    tensors, any ``module.`` prefix removed).  A file of tensors loads with
    ``weights_only=True``.  A pickled module (some open_clip releases)
    needs a full unpickle, which can run code from the file: it is done
    only with ``allow_pickle=True`` (the adapter passes it only when the
    file's sha256 matched a pin) and raises otherwise."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not allow_pickle:
            raise pickle.UnpicklingError(
                f"CLIP checkpoint {path} is not a plain file of tensors; "
                "loading it needs a full unpickle, which can run code from "
                "the file.  Pin its sha256 (expected_sha256=..., or "
                "open_clip's release filename) to allow it") from e
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v.float() for k, v in sd.items()}


def load_open_clip_state_dict(model: CLIPModel, sd) -> None:
    """Load an open_clip state_dict: every parameter of ``model`` must be
    in it (raises otherwise); entries the model has no parameter for (for
    example a saved ``attn_mask`` buffer) are ignored, as the JAX
    package's mapping ignores them."""
    missing, _ = model.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"open_clip state_dict lacks {missing}")


# ------------------------------------------------------------- the adapter

class OpenClipAdapter:
    """The reference-API adapter over the port's CLIP.

    Frozen: its parameters live outside every trainable module and
    optimizer.  ``embed_texts`` returns (l2-normed global embed, per-token
    encodings zero-masked past EOS); ``embed_images`` returns (l2-normed
    embed, (L, b, 1+n, d) per-layer encodings).  ``device=None`` means the
    card; a trainer moves the adapter to its own device."""

    def __init__(
        self,
        name="ViT-B/32",
        pretrained: Optional[str] = None,  # path to a torch checkpoint
        tokenizer_name: str = "ViT-B-32-quickgelu",
        eos_id: int = EOT_ID,
        bpe_path: Optional[str] = None,
        seed: int = 0,
        expected_sha256: Optional[str] = None,
        verify_checksum: bool = True,
        device=None,
    ):
        self.config = CONFIGS[name] if isinstance(name, str) else name
        self.eos_id = eos_id
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "OpenClipAdapter runs on a CUDA device by default and "
                    'none is available; pass device="cpu" to run on the CPU')
            device = "cuda"
        self.model = CLIPModel(self.config)

        self.has_pretrained_weights = (
            exists(pretrained) and Path(str(pretrained)).exists()
        )
        if self.has_pretrained_weights:
            pinned = False
            if verify_checksum:
                expected = checksum_pin(
                    pretrained,
                    expected_sha256 or KNOWN_SHA256_PREFIXES.get(
                        (name if isinstance(name, str) else "",
                         "laion400m_e32")
                        if "laion400m_e32" in Path(str(pretrained)).name
                        else ("", "")))
                digest = verify_checkpoint_checksum(pretrained, expected)
                pinned = expected is not None
                print(
                    f"[gigagan_tpu_torch] CLIP checkpoint sha256 "
                    f"{digest[:16]}… "
                    + ("verified" if pinned else "(no pin — recorded)")
                )
            load_open_clip_state_dict(
                self.model, load_open_clip_torch_checkpoint(
                    pretrained, allow_pickle=pinned))
        else:
            if exists(pretrained):
                print(
                    f"[gigagan_tpu_torch] CLIP checkpoint {pretrained!r} not "
                    "found on disk — using random init (no network egress "
                    "to download pretrained weights)"
                )
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.requires_grad_(False).eval()
        self.to(device)

        if exists(bpe_path) and Path(bpe_path).exists():
            self.tokenizer = SimpleTokenizer(
                bpe_path, self.config.context_length
            )
        else:
            self.tokenizer = HashTokenizer(
                self.config.context_length, self.config.vocab_size
            )

    def to(self, device):
        """Move the CLIP to ``device``; returns the adapter."""
        self.device = torch.device(device)
        self.model.to(self.device)
        return self

    # ----------------------------------------------------------- properties

    @property
    def uses_hash_tokenizer(self):
        return isinstance(self.tokenizer, HashTokenizer)

    @property
    def mock_reasons(self):
        """Why this adapter is a degraded stand-in for the reference's
        pretrained laion400m_e32 CLIP — empty when real weights and a real
        BPE vocab are loaded."""
        reasons = []
        if not self.has_pretrained_weights:
            reasons.append(
                "random-init CLIP weights (no checkpoint on disk)"
            )
        if self.uses_hash_tokenizer:
            reasons.append(
                "HashTokenizer fallback (no BPE vocab on disk) — token "
                "ids are hashes, not CLIP's vocabulary"
            )
        return reasons

    @property
    def dim_latent(self):
        return self.config.text_width

    @property
    def dim_image_latent(self):
        return self.config.vision_width

    @property
    def image_size(self):
        return self.config.image_size

    @property
    def image_channels(self):
        return 3

    @property
    def max_text_len(self):
        return self.config.context_length

    @property
    def logit_scale(self):
        with span("gigagan.sync.clip_logit_scale"):
            return float(self.model.logit_scale.exp())

    # ------------------------------------------------------------ embedding

    def tokenize(self, texts: List[str]):
        ids = self.tokenizer(texts)
        with span("gigagan.sync.clip_tokens"):
            return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    @staticmethod
    def text_mask_from_ids(ids, eos_id: int = EOT_ID):
        """Mask covering sot..eos inclusive."""
        excluding_eos = torch.cumsum(ids == eos_id, dim=-1) == 0
        mask = F.pad(excluding_eos[:, :-1], (1, 0), value=True)
        return mask & (ids != 0)

    def embed_texts(self, texts: List[str]):
        return self.embed_token_ids(self.tokenize(texts))

    def embed_token_ids(self, ids):
        """(l2-normed embed (b, embed_dim), encodings (b, n, width) zeroed
        past EOS), float32."""
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        mask = self.text_mask_from_ids(ids, self.eos_id)
        text_embed, encodings = self.model.encode_text(ids)
        encodings = torch.where(mask[..., None], encodings,
                                torch.zeros((), device=self.device))
        return _l2norm(text_embed), encodings.float()

    def normalize_images(self, images):
        """[0, 1] (b, h, w, 3) → CLIP-normalised at CLIP's input size (the
        reference adapter's resize is ``F.interpolate``'s default,
        nearest)."""
        if images.shape[-2] != self.image_size:
            images = ops.resize_image_to(images, self.image_size, "nearest")
        with span("gigagan.sync.clip_normalize"):
            mean = torch.tensor(OPENAI_IMAGE_MEAN, dtype=images.dtype,
                                device=images.device)
        with span("gigagan.sync.clip_normalize"):
            std = torch.tensor(OPENAI_IMAGE_STD, dtype=images.dtype,
                               device=images.device)
        return (images - mean) / std

    def embed_images(self, images):
        """(l2-normed embed, taps (L, b, 1+n, width)) of images in [0, 1],
        float32; gradients flow to the images."""
        image_embed, taps = self.model.encode_image(
            self.normalize_images(images.float()))
        return _l2norm(image_embed), taps.float()

    def contrastive_loss(self, images, texts=None, text_embeds=None):
        from gigagan_tpu_torch.losses import clip_contrastive_loss

        assert exists(texts) ^ exists(text_embeds)
        if not exists(text_embeds):
            text_embeds, _ = self.embed_texts(texts)
        image_embeds, _ = self.embed_images(images)
        return clip_contrastive_loss(image_embeds, text_embeds,
                                     self.logit_scale)


def _l2norm(t):
    t = t.float()
    return t / t.norm(dim=-1, keepdim=True).clamp(min=1e-12)
