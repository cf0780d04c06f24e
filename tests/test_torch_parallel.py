"""Data parallel in the port (``gigagan_tpu_torch/parallel``): 2 ranks of
a gloo process group on the CPU, each a spawned process
(``torch.multiprocessing``, ``tests/torch_dp_worker.py``) under a 120 s
timeout, at a tiny width.

- a d_step with R1 and a g_step, unconditional and text-conditioned (the
  matching-aware roll across ranks; the contrastive loss over the global
  pool, through ``losses.all_gather_batch`` without accumulation and the
  pooled gradient with it), against one process at the global batch:
  losses within 1e-5 relative, every gradient the optimizers stepped with
  within 1e-4 × max |want| of its leaf, and the ranks' updated parameters
  bitwise equal;
- ``losses.all_gather_batch``'s value and gradient against the JAX
  package's ``all_gather_batch`` under ``shard_map`` on 2 CPU devices;
- ``DataLoader`` shards: disjoint, their union the epoch, in the JAX
  loader's order;
- ``save`` and the sample grids written by rank 0 only.
"""

import socket
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp_worker as worker  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from gigagan_tpu import losses as jlosses  # noqa: E402
from gigagan_tpu.data import DataLoader as JaxDataLoader  # noqa: E402

from gigagan_tpu_torch.data import DataLoader  # noqa: E402

WORLD = 2
TIMEOUT_S = 120
LOSS_RTOL = 1e-5  # a loss, relative
GRAD_TOL = 1e-4   # a gradient leaf, relative to its max |want|


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(case, args, out_dir):
    """Every rank's result of ``worker.CASES[case]``."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=worker.run,
                         args=(rank, WORLD, port, case, args, str(out_dir)))
             for rank in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT_S)
            assert p.exitcode == 0, (
                f"rank {procs.index(p)} ended with {p.exitcode} "
                f"(None: still running after {TIMEOUT_S} s)")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def leaf_err(got, want):
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


@pytest.mark.parametrize("kind,accum", [("uncond", 1), ("text", 1),
                                        ("text", 2)],
                         ids=["uncond", "text", "text_accum2"])
def test_two_ranks_equal_one_process_at_the_global_batch(tmp_path, kind,
                                                         accum):
    ranks = run_ranks("step", (kind, accum), tmp_path)
    want = worker.step_result(kind, accum)
    if kind == "text":  # the text terms are in play
        assert want["d"]["matching_aware_loss"] > 0
        assert want["g"]["contrastive_loss"] > 0
        assert want["d"]["vision_aided_divergence"] > 0
    assert want["d"]["gradient_penalty"] > 0
    for got in ranks:
        for step in ("d", "g"):
            assert set(got[step]) == set(want[step])
            for k, v in want[step].items():
                assert abs(got[step][k] - v) <= LOSS_RTOL * max(abs(v),
                                                                1e-6), (
                    f"{step} {k}: {got[step][k]} vs {v}")
        for module in ("D", "VD", "G"):
            if module not in want:
                continue
            assert set(got[module]) == set(want[module]), module
            for name, w in want[module].items():
                assert leaf_err(got[module][name], w) <= GRAD_TOL, (
                    f"{module}.{name}")
    # the ranks stepped with the same averaged gradients: the same bits
    for a, b in zip(*(r["checksum"] for r in ranks), strict=True):
        assert torch.equal(a, b)


def test_all_gather_batch_matches_jax_shard_map(tmp_path):
    ranks = run_ranks("gather", (), tmp_path)
    rng = np.random.default_rng(0)  # the worker's draws
    x = rng.standard_normal((WORLD, 3, 5)).astype(np.float32)
    w = rng.standard_normal((WORLD, WORLD * 3, 5)).astype(np.float32)

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("d",))
    shard_map = partial(jax.shard_map, mesh=mesh, check_vma=False)

    def per_device(xs, ws):
        gathered = jlosses.all_gather_batch(xs, "d")
        return gathered[None], jnp.sum(gathered * ws[0])[None]

    run = shard_map(per_device, in_specs=(P("d"), P("d")),
                    out_specs=(P("d"), P("d")))
    gathered, _ = run(jnp.asarray(x.reshape(-1, 5)), jnp.asarray(w))
    grad = jax.grad(lambda xf: jnp.sum(run(xf, jnp.asarray(w))[1]))(
        jnp.asarray(x.reshape(-1, 5)))
    grad = np.asarray(grad).reshape(WORLD, 3, 5)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["value"].numpy(),
                                      np.asarray(gathered)[r])
        np.testing.assert_allclose(got["grad"].numpy(), grad[r],
                                   rtol=1e-6, atol=1e-6)


class IndexDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((1,), i, np.int64)


@pytest.mark.parametrize("n", [64, 67])
def test_loader_shards_are_the_jax_loaders(n):
    ds = IndexDataset(n)
    ours = [DataLoader(ds, 4, shuffle=True, drop_last=True, seed=123,
                       prefetch=0, num_workers=1, process_index=i,
                       process_count=WORLD) for i in range(WORLD)]
    theirs = [JaxDataLoader(ds, 4, seed=123, prefetch=0, num_workers=1,
                            process_index=i, process_count=WORLD)
              for i in range(WORLD)]
    assert [len(d) for d in ours] == [len(d) for d in theirs] == [
        (n // WORLD) // 4] * WORLD
    for _ in range(2):  # each epoch re-permutes in lockstep
        seen = []
        for a, b in zip(ours, theirs):
            got = [batch.reshape(-1).tolist() for batch in a]
            want = [batch[0].reshape(-1).tolist() for batch in b]
            assert got == want
            seen.append({i for batch in got for i in batch})
        assert seen[0].isdisjoint(seen[1])
        assert len(seen[0] | seen[1]) == (n // WORLD) // 4 * 4 * WORLD
    # without a process group, one process takes the whole epoch
    whole = DataLoader(ds, 4, shuffle=True, drop_last=True, seed=1,
                       prefetch=0, num_workers=1)
    assert len(whole) == n // 4
    drawn = [i for b in whole for i in b.reshape(-1).tolist()]
    assert len(set(drawn)) == len(drawn) == n // 4 * 4
    assert set(drawn) <= set(range(n))


def test_save_on_rank_zero_only(tmp_path):
    ranks = run_ranks("save", (), tmp_path)
    assert ranks[0]["files"] == ["ema-sample-0.png", "model-0.ckpt",
                                 "sample-0.png"]
    assert ranks[1]["files"] == []
