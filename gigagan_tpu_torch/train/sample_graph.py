"""G's forward for ``GigaGAN.generate``, replayed as a CUDA graph on the card.

A request's forward is some 700 kernel launches, most of them small: at
batch 1 the card runs them in a fraction of the time Python takes to issue
them.  On CUDA, ``forward`` replays a graph of G's forward captured for
the request's shapes instead.  The graph holds the kernels the eager
forward launches (the hand-written ones, cuDNN's, cuBLAS's and aten's), in
the same order and precision, so a replay gives the eager pixels bit for
bit.

- **When**: ``graph_key`` names a graph for a call on a CUDA device that
  is not the upsampler's (its forward copies an index vector to the card
  on every call) and not under ``plain_reference()``; every other call
  runs eagerly.  One graph per key: the batch size, G's dtype and the
  shape and dtype of each of ``styles``, ``noise`` and ``text_encodings``
  given.
- **Capture**: at a key's second call.  The first runs eagerly, which
  builds the kernels, lets cuDNN and cuBLAS pick their algorithms and
  fills the blur filters' cache, so that the capture issues nothing but
  the forward's own work.
- **Where**: each generator module keeps its graphs (``graphs_of``), at
  most ``MAX_GRAPHS`` keys, the least recently used evicted with its
  memory pool; a copy of the module (``copy.deepcopy``) starts with none.
- **Inputs and RNG**: the given inputs are copied into the graph's own
  buffers.  Each graph owns its latent and noise generators, registered
  with it; before a replay both are seeded with the request's seeds, as
  the eager path seeds fresh generators, so the draws are the same.
- **Weights**: a replay reads the parameters' storage, so updates that
  copy into it are seen: ``load_state_dict`` (``load``,
  ``create_ema_generator``, ``load_jax_params``), the optimizers, the EMA.
  Nothing in the port gives G or G_ema new parameter tensors after
  ``__init__``; code that did would have to forget their graphs.

The kernel entries' Python ``.launches`` counters count the eager
warm-up and the capture, not the replays.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from gigagan_tpu_torch.ops.kernels import use_fused
from gigagan_tpu_torch.utils import span

MAX_GRAPHS = 4
INPUTS = ("styles", "noise", "text_encodings")
# the marker of a key seen once: its next call captures
WARM = "warm"


def graph_key(device, upsampler: bool, batch_size: int, dtype, inputs):
    """The key of the graph that replays this call's forward, or None where
    it runs eagerly: on a CPU, for the upsampler, under
    ``plain_reference()``.  ``inputs`` maps ``INPUTS`` to tensors or
    None."""
    if torch.device(device).type != "cuda" or upsampler or not use_fused():
        return None
    given = tuple(None if inputs.get(k) is None
                  else (tuple(inputs[k].shape), inputs[k].dtype)
                  for k in INPUTS)
    return (batch_size, dtype, given)


class Graphs:
    """A module's captured forwards by key (``WARM`` for a key seen once),
    the most recently used last; at most ``limit`` keys."""

    def __init__(self, limit: int = MAX_GRAPHS):
        self.limit = limit
        self.entries = OrderedDict()

    def __reduce__(self):  # a copy or a pickle of the module holds none
        return Graphs, (self.limit,)

    def get(self, key):
        """The entry of ``key`` (None if unknown), now the most recent."""
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def put(self, key, entry) -> None:
        self.entries[key] = entry
        self.entries.move_to_end(key)
        while len(self.entries) > self.limit:
            self.entries.popitem(last=False)


def graphs_of(module) -> Graphs:
    """The graphs ``module`` keeps (made empty on first use)."""
    graphs = module.__dict__.get("_sample_graphs")
    if graphs is None:
        graphs = module._sample_graphs = Graphs()
    return graphs


def _generators(device, seeds):
    noise_gen, latent_gen = (torch.Generator(device=device)
                             for _ in range(2))
    noise_gen.manual_seed(seeds[0])
    latent_gen.manual_seed(seeds[1])
    return noise_gen, latent_gen


def _call(g, batch_size, inputs, noise_gen, latent_gen):
    return g(**inputs, batch_size=batch_size, latent_generator=latent_gen,
             noise_generator=noise_gen)


class Captured:
    """One captured forward: the graph, its input buffers, its output and
    its two generators."""

    def __init__(self, g, device, batch_size: int, inputs):
        self.device = torch.device(device)
        self.inputs = {k: v.clone() for k, v in inputs.items()
                       if v is not None}
        self.noise_gen, self.latent_gen = _generators(self.device, (0, 0))
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.noise_gen)
        self.graph.register_generator_state(self.latent_gen)
        with span("gigagan.sample.graph_capture"), \
                torch.cuda.device(self.device), \
                torch.cuda.graph(self.graph,
                                 stream=torch.cuda.Stream(self.device)):
            self.out = _call(g, batch_size, self.inputs, self.noise_gen,
                             self.latent_gen)

    def replay(self, seeds, inputs):
        """The forward of the request with ``seeds`` (noise, latent) and
        ``inputs``; the output tensor is overwritten by the next replay."""
        with span("gigagan.sample.graph_replay"), \
                torch.cuda.device(self.device):
            for k, buf in self.inputs.items():
                buf.copy_(inputs[k])
            self.noise_gen.manual_seed(seeds[0])
            self.latent_gen.manual_seed(seeds[1])
            self.graph.replay()
        return self.out


def forward(g, key, device, batch_size: int, seeds, inputs):
    """G's forward for one ``generate`` call: ``g(**inputs, batch_size=)``
    with the latent and the pixel noise drawn from generators seeded with
    ``seeds`` (noise, latent); replayed as a graph where ``key`` (from
    ``graph_key``) names one, captured at the key's second call."""
    if key is None:
        return _call(g, batch_size, inputs, *_generators(device, seeds))
    graphs = graphs_of(g)
    entry = graphs.get(key)
    if entry is None:
        graphs.put(key, WARM)
        return _call(g, batch_size, inputs, *_generators(device, seeds))
    if entry is WARM:
        entry = Captured(g, device, batch_size, inputs)
        graphs.put(key, entry)
    return entry.replay(seeds, inputs)
