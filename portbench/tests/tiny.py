"""Tiny configurations of the two benchmark configurations' shapes (the
same modules and options at 32px), for the CPU tests: the port runs its
kernels' plain versions there."""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from portbench import harness
from portbench.run import Context

TRAFFIC = harness.PACKAGE / "traffic"
QS = {"generator": {"image_size": 32, "dim_capacity": 4, "dim_max": 32,
                    "dim_latent": 32, "style_network": {"dim": 32, "depth": 2},
                    "num_skip_layers_excite": 2, "unconditional": True,
                    "self_attn_resolutions": [8], "self_attn_dim_head": 16,
                    "self_attn_heads": 2},
      "discriminator": {"image_size": 32, "dim_capacity": 4, "dim_max": 32,
                        "num_skip_layers_excite": 2, "unconditional": True,
                        "attn_resolutions": [8], "attn_dim_head": 16,
                        "attn_heads": 2,
                        "multiscale_input_resolutions": [16, 8]},
      "amp": False}
CLIP = {"name": "ViT-B/32", "image_size": 32, "patch_size": 16,
        "vision_width": 32, "vision_layers": 3, "vision_heads": 2,
        "text_width": 32, "text_layers": 2, "text_heads": 2, "embed_dim": 32,
        "context_length": 16}
TEXT = {"dim": 32, "depth": 1, "clip_dim": 32, "dim_head": 16, "heads": 2}
T2I = {"generator": {**QS["generator"], "unconditional": False,
                     "dim_max": 64, "dim_latent": 64, "text_encoder": TEXT,
                     "style_network": {"dim": 32, "depth": 2,
                                       "dim_text_latent": 32},
                     "cross_attn_resolutions": [8],
                     "cross_attn_dim_head": 16, "cross_attn_heads": 2},
       "discriminator": {**QS["discriminator"], "unconditional": False,
                         "text_encoder": TEXT},
       "vision_aided_discriminator": {"layer_indices": [-1, -2],
                                      "conv_dim": 32, "unconditional": False,
                                      "clip_image_dim": 32,
                                      "clip_text_dim": 32},
       "clip": CLIP, "amp": False}


def traffic(name: str, **changes) -> dict:
    return {**json.loads((TRAFFIC / f"{name}.json").read_text()), **changes}


def cell(config: dict, traffic_: dict, limits=None,
         name: str = "tiny") -> harness.Cell:
    return harness.Cell(name=name, chips=1, config=config,
                        traffic=traffic_, limits=limits or {},
                        end_to_end=[], per_layer=[])


def context(cell_: harness.Cell, tmp: Path, seed: int = 2 ** 31 + 7,
            seconds: float = 0.5, trace: bool = False, plant=None):
    torch.manual_seed(0)
    return Context(cell_, seed, seconds, trace, torch.device("cpu"),
                   time.perf_counter(), tmp, plant=plant)


def train_cell(config=QS, limits=None):
    name = "train-b8" if config is T2I else "train-b32"
    return cell(config, traffic(name, batch=4), limits)


def sample_cell(config=QS, limits=None):
    return cell(config, traffic("sample-b1"), limits)
