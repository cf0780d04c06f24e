"""A tiny configuration of the ``upsampler-256`` configuration's shapes
(the same modules and options: 32² from 8², three stages of which two skip
their downsampling, linear attention at 8² (two stages), 16² and 32², full
attention at 8² and 4², 2 heads of 8, a D reading a 16² rgb), for the CPU
tests: the port runs its kernels' plain versions there."""

from __future__ import annotations

from portbench.tests import tiny

UP = {"generator": {"dim": 8, "image_size": 32, "input_image_size": 8,
                    "dim_mults": [1, 2, 4],
                    "full_attn": [False, False, True],
                    "cross_attn": [False, False, False],
                    "attn_depths": [1, 1, 1],
                    "temporal_attn_depths": [1, 1, 1],
                    "self_attn_heads": 2, "self_attn_dim_head": 8,
                    "cross_attn_dim_head": 8, "unconditional": True,
                    "style_network": {"dim": 16, "depth": 2}},
      "discriminator": {"image_size": 32, "dim_capacity": 4, "dim_max": 32,
                        "num_skip_layers_excite": 2, "unconditional": True,
                        "attn_resolutions": [8], "attn_dim_head": 16,
                        "attn_heads": 2,
                        "multiscale_input_resolutions": [16]},
      "trainer": {"train_upsampler": True},
      "amp": False}
# the LinearAttention2D modules of one forward of UP's G
LINEAR_ATTENTIONS = 4


def train_cell(limits=None):
    return tiny.cell(UP, tiny.traffic("train-up-b8", batch=4), limits)
