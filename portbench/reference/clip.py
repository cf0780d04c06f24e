"""The reference's CLIP: a frozen copy of the port's ViT-B/32 towers
(``gigagan_tpu_torch/models/clip.py``, open_clip's parameter names), its
hash tokenizer and the adapter's embedding functions, in float32 with
plain attention."""

from __future__ import annotations

import hashlib
import math
import re
from collections import OrderedDict
from dataclasses import dataclass
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import numerics as nm
from portbench.reference import ops
from portbench.reference.utils import exists

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


class Linear(nn.Linear):
    """``nn.Linear`` whose product goes through the reference's numerics."""

    def forward(self, x):
        return nm.linear(x, self.weight, self.bias)


class _Attention(nn.Module):
    """Multi-head self-attention with ``nn.MultiheadAttention``'s parameter
    names (packed ``in_proj_weight``/``in_proj_bias``, ``out_proj``), on
    (b, n, w), with an optional additive (n, n) mask."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = Linear(width, width)

    def forward(self, x, mask=None):
        b, n, w = x.shape
        d = w // self.heads
        q, k, v = nm.linear(x, self.in_proj_weight,
                            self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, self.heads, d).transpose(1, 2)
                   for t in (q, k, v))
        sim = nm.matmul(q * d ** -0.5, k.transpose(-1, -2))
        if exists(mask):
            sim = sim + mask
        out = nm.matmul(sim.softmax(dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, w))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then x + mlp(ln_2(x))."""

    def __init__(self, width: int, heads: int, quick_gelu_act: bool = True):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", Linear(width, width * 4)),
            ("gelu", QuickGELU() if quick_gelu_act else nn.GELU()),
            ("c_proj", Linear(width * 4, width)),
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
        x = nm.conv2d(images.permute(0, 3, 1, 2), self.conv1.weight,
                       stride=self.conv1.stride)
        b, w = x.shape[:2]
        x = x.reshape(b, w, -1).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, w)
        x = torch.cat((cls, x), dim=1)
        x = self.ln_pre(x + self.positional_embedding[:x.shape[1]])
        taps = []
        for block in self.transformer.resblocks:
            x = block(x)
            taps.append(x)
        return nm.matmul(self.ln_post(x[:, 0]), self.proj), torch.stack(taps)


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
        return nm.matmul(pooled, self.text_projection), encodings


class CLIPModel(CLIPTextTower):
    """The text tower's parameters at the top level, the vision tower under
    ``visual`` and ``logit_scale``: open_clip's ``CLIP`` layout."""

    def __init__(self, cfg: CLIPConfig = VIT_B_32):
        super().__init__(cfg)
        self.config = cfg
        self.visual = CLIPVisionTower(cfg)
        self.logit_scale = nn.Parameter(torch.empty(()))

    @torch.no_grad()
    def reset_parameters(self, draws):
        """The JAX package's initial distributions: LayerNorm 1 and 0,
        Dense, attention and patch kernels lecun-normal, biases 0, the
        token embedding N(0, 1/width), the text positions N(0, 0.01²), the
        class token, image positions and projections N(0, 1/width),
        logit_scale log(1/0.07)."""
        cfg = self.config

        def normal(p, std):
            draws.normal_(p, 0.0, std)

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


class HashTokenizer:
    """Deterministic offline stand-in: word → stable-hash id.  Keeps the
    (sot, ..., eot, pad) contract so the masking downstream works; NOT
    CLIP's vocabulary."""

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


def _l2norm(t):
    t = t.float()
    return t / t.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def text_mask_from_ids(ids, eos_id: int = EOT_ID):
    """Mask covering sot..eos inclusive."""
    excluding_eos = torch.cumsum(ids == eos_id, dim=-1) == 0
    mask = F.pad(excluding_eos[:, :-1], (1, 0), value=True)
    return mask & (ids != 0)


class ClipAdapter:
    """The adapter's embeddings over a ``CLIPModel`` and the hash
    tokenizer: ``embed_texts`` → (l2-normed embed, token encodings zeroed
    past EOS); ``embed_images`` → (l2-normed embed, (L, b, 1+n, d) taps)."""

    def __init__(self, model: CLIPModel):
        self.model = model
        self.config = model.config
        self.tokenizer = HashTokenizer(self.config.context_length,
                                       self.config.vocab_size)

    @property
    def device(self):
        return self.model.logit_scale.device

    @property
    def logit_scale(self):
        return float(self.model.logit_scale.exp())

    def embed_texts(self, texts: List[str]):
        ids = torch.as_tensor(self.tokenizer(list(texts)), dtype=torch.long,
                              device=self.device)
        mask = text_mask_from_ids(ids)
        text_embed, encodings = self.model.encode_text(ids)
        encodings = torch.where(mask[..., None], encodings,
                                torch.zeros((), device=self.device))
        return _l2norm(text_embed), encodings.float()

    def normalize_images(self, images):
        size = self.config.image_size
        if images.shape[-2] != size:
            images = ops.resize_image_to(images, size, "nearest")
        mean = torch.tensor(OPENAI_IMAGE_MEAN, dtype=images.dtype,
                            device=images.device)
        std = torch.tensor(OPENAI_IMAGE_STD, dtype=images.dtype,
                           device=images.device)
        return (images - mean) / std

    def embed_images(self, images):
        image_embed, taps = self.model.encode_image(
            self.normalize_images(images.float()))
        return _l2norm(image_embed), taps.float()
