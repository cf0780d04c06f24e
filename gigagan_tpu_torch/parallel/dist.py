"""Data parallelism over ``torch.distributed`` (counterpart of
gigagan_tpu/parallel/mesh.py).

JAX shards the batch over a 1-D ``data`` mesh, keeps parameters and
optimizer state replicated, and lets XLA all-reduce the gradients: no
DDP wrapper, no hooks.  The port does the same by hand, one process per
rank:

- every rank builds the same parameters from the shared seed
  (``assert_replicated`` checks it once, by a checksum broadcast from rank
  0), takes its slice of the global batch, and all-reduces the gradients
  (``all_reduce_mean_``, flattened into buckets) after the last
  microbatch's backward and before each optimizer step.  Parameters,
  optimizer states, the EMA and the step counter then stay identical
  because their inputs are.  ``DistributedDataParallel`` is not used: R1's
  ``torch.autograd.grad(..., create_graph=True)`` and the g_step's
  ``backward(inputs=...)`` go around its reducer hooks;
- the step's random draws are those of the global batch: inside
  ``global_batch_draws(rank, world)`` the models draw through ``randn`` and
  ``rand`` here, which draw the whole batch's tensor from the shared
  generator and keep this rank's slice, so a step of ``world`` ranks
  equals one process's step at the global batch (JAX's one key per global
  batch);
- ``all_gather_cat`` gathers a batch without gradient (the matching-aware
  roll, the contrastive pool); ``losses.all_gather_batch`` is the
  differentiable gather.

The process group comes from the usual ``torchrun`` environment
(``init_from_env``, when ``WORLD_SIZE`` > 1) or from ``init`` with an
explicit address.  It runs NCCL when each rank has a device of its own and
gloo otherwise (two ranks sharing one card, or the CPU); over gloo a CUDA
tensor is sent through host memory, over NCCL a host tensor through the
card.  Without a process group every
function here is the single-process identity.
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch
import torch.distributed as torch_dist

# bytes of one flattened all-reduce bucket
BUCKET_BYTES = 1 << 28

_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "gigagan_batch_shard", default=None)


def is_initialized() -> bool:
    return torch_dist.is_available() and torch_dist.is_initialized()


def rank() -> int:
    return torch_dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return torch_dist.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def backend() -> str:
    return torch_dist.get_backend() if is_initialized() else ""


def default_backend(world: int) -> str:
    """NCCL when each of this host's ranks has a CUDA device of its own,
    else gloo."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init(backend_name=None, init_method: str = "env://", world=None,
         rank_=None):
    """Start the process group (``world``/``rank_`` default to the
    environment's ``WORLD_SIZE``/``RANK``)."""
    world = int(os.environ.get("WORLD_SIZE", 1)) if world is None else world
    rank_ = int(os.environ.get("RANK", 0)) if rank_ is None else rank_
    torch_dist.init_process_group(
        backend=backend_name or default_backend(world),
        init_method=init_method, world_size=world, rank=rank_)


def init_from_env() -> bool:
    """Start the process group from a ``torchrun`` environment when it
    names more than one rank and none exists; whether one exists."""
    if not is_initialized() and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        init()
    return is_initialized()


def barrier():
    if is_initialized():
        torch_dist.barrier()


def _for_backend(t):
    """The tensor a collective takes: gloo's go through host memory,
    NCCL's through the card."""
    if backend() == "gloo" and t.is_cuda:
        return t.cpu()
    if backend() == "nccl" and not t.is_cuda:
        return t.cuda()
    return t


def all_reduce_sum_(t):
    """Sum ``t`` over the ranks, in place."""
    if not is_initialized():
        return t
    comm = _for_backend(t)
    torch_dist.all_reduce(comm)
    if comm is not t:
        t.copy_(comm)
    return t


def all_reduce_mean_(tensors):
    """Average each tensor over the ranks, in place, flattened into buckets
    of one dtype and device, at most ``BUCKET_BYTES`` each (a few collectives
    for hundreds of leaves)."""
    tensors = [t for t in tensors if t is not None]
    if not is_initialized() or not tensors:
        return
    world = world_size()
    buckets, size = [[]], 0
    for t in sorted(tensors, key=lambda t: (str(t.dtype), str(t.device))):
        last = buckets[-1]
        nbytes = t.numel() * t.element_size()
        if last and (size + nbytes > BUCKET_BYTES
                     or (last[0].dtype, last[0].device)
                     != (t.dtype, t.device)):
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += nbytes
    for bucket in buckets:
        flat = torch.cat([t.reshape(-1) for t in bucket])
        all_reduce_sum_(flat)
        flat.div_(world)
        start = 0
        for t in bucket:
            t.copy_(flat[start:start + t.numel()].view_as(t))
            start += t.numel()


def all_gather_cat(t):
    """Every rank's ``t`` concatenated along the leading axis, rank-major,
    without gradient."""
    if not is_initialized():
        return t
    t = t.detach().contiguous()
    comm = _for_backend(t)
    parts = [torch.empty_like(comm) for _ in range(world_size())]
    torch_dist.all_gather(parts, comm)
    return torch.cat(parts).to(t.device)


def checksum(tensors) -> torch.Tensor:
    """One int64 per tensor: the sum of its bits read as integers, weighted
    by position (equal checksums mean equal bits, up to collisions no
    rounding difference produces)."""
    views = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in tensors:
        bits = t.detach().contiguous().reshape(-1).view(
            views[t.element_size()]).long()
        weight = torch.arange(1, bits.numel() + 1, device=bits.device) % 8191
        out.append((bits * (weight + 1)).sum())
    return torch.stack(out).cpu()


def assert_replicated(tensors, what: str = "parameters"):
    """Raise unless every rank holds the bits rank 0 holds."""
    if not is_initialized():
        return
    mine = checksum(list(tensors))
    ref = _for_backend(mine.clone())
    torch_dist.broadcast(ref, src=0)
    bad = (ref.cpu() != mine).nonzero().flatten().tolist()
    if bad:
        raise RuntimeError(f"rank {rank()}: {len(bad)} {what} differ from "
                           f"rank 0's (first index {bad[0]})")


@contextlib.contextmanager
def global_batch_draws(rank_: int, world: int):
    """Inside: ``randn``/``rand`` draw the global batch (``world`` times
    the leading axis) and keep rank ``rank_``'s slice."""
    token = _SHARD.set((rank_, world))
    try:
        yield
    finally:
        _SHARD.reset(token)


def batch_draws():
    """``global_batch_draws`` for this rank of the process group; without
    one, the draws as they are (inside an enclosing ``global_batch_draws``,
    that rank's slice: one process can take each rank's step in turn)."""
    if not is_initialized():
        return contextlib.nullcontext()
    return global_batch_draws(rank(), world_size())


def _draw(fn, shape, kwargs):
    shard = _SHARD.get()
    if shard is None or shard[1] == 1:
        return fn(shape, **kwargs)
    r, world = shard
    b = shape[0]
    return fn((world * b, *shape[1:]), **kwargs)[r * b:(r + 1) * b]


def randn(shape, **kwargs):
    """``torch.randn`` of a batch-leading ``shape``; this rank's slice of
    the global batch's draw inside ``global_batch_draws``."""
    return _draw(torch.randn, tuple(shape), kwargs)


def rand(shape, **kwargs):
    """``torch.rand`` as ``randn``."""
    return _draw(torch.rand, tuple(shape), kwargs)
