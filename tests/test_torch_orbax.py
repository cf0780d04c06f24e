"""The port's reader of the JAX package's orbax checkpoints, layer by
layer, each against the real library:

- the hand-written zstd decoder (``csrc/zstd_decode.c`` through
  ``utils/zstd.py``) against ``zstandard``: levels 1 to 22 with a long
  window, with and without a checksum, on random, zero, repetitive, text,
  mixed and real fp32/bf16 parameter bytes, byte for byte; frames without
  a declared size, several frames with a skippable one between, and every
  chunk frame tensorstore wrote for the fixture; corrupt input (bad magic,
  truncation, a wrong checksum, a dictionary, random byte flips) raises
  or, where the flip changes nothing that decoding reads, gives the
  original bytes; CRC-32C against its definition;
- the OCDBT reader (``train/ocdbt.py``) against tensorstore's ``ocdbt``
  kvstore, every key and value: the fixture, a quickstart-depth state
  written by the JAX trainer (803 leaves, narrow), databases that
  tensorstore wrote with interior nodes, many versions, no compression, a
  zstd level and numbered manifests, and a 3-process save merged as
  orbax merges one;
- zarr v2 arrays (``train/orbax_checkpoint.py``) against tensorstore's
  own reading of the arrays it wrote: ragged edge chunks, missing chunks
  (the fill value), every dtype the reader takes, zstd and no compressor,
  in files and in OCDBT;
- the payload against the JAX trainer's own ``_read_checkpoint`` (orbax's
  ``restore``), leaf for leaf, bitwise and of the same dtype: the fixture,
  the quickstart-depth state, a multi-chunk save, a ``use_ocdbt=False``
  save and the bare-state layout;
- ``GigaGAN.load`` of ``torch_fixtures/jax_model_orbax`` bitwise equal to
  that of ``jax_model`` (the same state saved as msgpack), ``generate``
  on the orbax folder with the JAX generator's outputs, and a resumed
  run that would overwrite an orbax directory raising
  ``FileExistsError``;
- reading a checkpoint loads none of jax, orbax, tensorstore, zstandard,
  xxhash or msgpack, and no system zstd library.

``test_full_width_state`` (marked ``slow``) reads the quickstart's
full-width state, 1.14 GiB, once: bitwise against orbax, and its decode
rate.
"""

import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
zstandard = pytest.importorskip("zstandard")
ts = pytest.importorskip("tensorstore")
ocp = pytest.importorskip("orbax.checkpoint")

from gigagan_tpu.train import GigaGAN as JaxGigaGAN  # noqa: E402

from gigagan_tpu_torch import cli  # noqa: E402
from gigagan_tpu_torch.models import layers as tl  # noqa: E402
from gigagan_tpu_torch.ops.kernels import build  # noqa: E402
from gigagan_tpu_torch.train import jax_checkpoint  # noqa: E402
from gigagan_tpu_torch.train import orbax_checkpoint  # noqa: E402
from gigagan_tpu_torch.train.ocdbt import OcdbtReader  # noqa: E402
from gigagan_tpu_torch.utils import png, zstd  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
ORBAX_CKPT = FIXTURES / "jax_model_orbax" / "model-1.ckpt"
JAX_OUT_TOL = 1e-4  # the G outputs against JAX's, relative (fp32, CPU)
# the quickstart's G and D (gigagan_tpu/cli.py defaults) at its depth; the
# widths cut to 1-8 channels so that the JAX trainer builds it in seconds
QUICKSTART_NARROW = dict(
    generator=dict(dim_capacity=1, dim_latent=8,
                   style_network=dict(dim=8, depth=4), image_size=256,
                   dim_max=8, num_skip_layers_excite=4, unconditional=True),
    discriminator=dict(dim_capacity=1, dim_max=8, image_size=256,
                       num_skip_layers_excite=4, unconditional=True),
    amp=True)


# ------------------------------------------------------------------ zstd


def _sweep_data():
    rng = np.random.default_rng(0)
    w = rng.standard_normal(64 * 1024).astype(np.float32)
    fixture = jax_checkpoint.read_checkpoint(FIXTURES / "jax_model"
                                             / "model-1.ckpt")
    params = b"".join(
        v.numpy().tobytes() for _, v in sorted(_leaves(fixture["state"]))
        if torch.is_tensor(v) and v.dtype == torch.float32)
    return {
        "random": rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes(),
        "zero": bytes(300_000),
        "repetitive": (b"abcdefgh" * 3 + b"xyz") * 9000,
        "text": (REPO / "gigagan_tpu_torch" / "train"
                 / "trainer.py").read_bytes(),
        "fp32_params": params,
        "bf16_params": (np.frombuffer(params, np.uint32) >> 16)
        .astype(np.uint16).tobytes(),
        "mixed": (w[:20000].tobytes() + bytes(40000) + b"abc" * 9000
                  + rng.integers(0, 4, 60000, dtype=np.uint8).tobytes()),
    }


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*prefix, k))
    else:
        yield prefix, tree


def _compress(data, level, checksum):
    if level == 22:  # --ultra with a 128 MiB window and long matching
        params = zstandard.ZstdCompressionParameters.from_level(
            22, window_log=27, enable_ldm=True, write_checksum=checksum)
        return zstandard.ZstdCompressor(compression_params=params) \
            .compress(data)
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum) \
        .compress(data)


@pytest.fixture(scope="module")
def sweep_data():
    return _sweep_data()


@pytest.mark.parametrize("checksum", [False, True],
                         ids=["no_checksum", "checksum"])
@pytest.mark.parametrize("level", [1, 3, 9, 19, 22])
@pytest.mark.parametrize("kind", ["random", "zero", "repetitive", "text",
                                  "fp32_params", "bf16_params", "mixed"])
def test_zstd_matches_zstandard(sweep_data, kind, level, checksum):
    data = sweep_data[kind]
    frame = _compress(data, level, checksum)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data
    assert decode(frame, len(data) + 7) == data


def decode(frame, capacity):
    """``frame`` decoded into a buffer of ``capacity`` bytes."""
    out = np.empty(capacity, np.uint8)
    return out[:zstd.decompress_into(frame, out)].tobytes()


def test_zstd_frames_without_size_several_frames_and_skippable():
    rng = np.random.default_rng(1)
    data = rng.standard_normal(300_000).astype(np.float32).tobytes()
    c = zstandard.ZstdCompressor(level=3, write_content_size=False)
    obj = c.compressobj()
    stream = obj.compress(data[:500_000]) + obj.compress(data[500_000:]) \
        + obj.flush()
    assert zstd.decompress(stream) == data  # no size: the capacity grows
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(
        4, "little") + b"12345"
    frames = (zstandard.ZstdCompressor(level=1).compress(data[:5000])
              + skippable
              + zstandard.ZstdCompressor(level=5, write_checksum=True)
              .compress(data[5000:9000])
              + zstandard.ZstdCompressor().compress(b""))
    assert zstd.decompress(frames) == data[:9000]
    assert zstd.decompress(zstandard.ZstdCompressor().compress(b"")) == b""


def test_zstd_decodes_tensorstores_chunks():
    db = OcdbtReader(ORBAX_CKPT)
    frames = [db.read(k) for k in db.keys() if not k.endswith(".zarray")]
    assert len(frames) > 300
    for frame in frames:
        assert frame[:4] == b"\x28\xb5\x2f\xfd"
        # tensorstore's frames declare no content size
        want = zstandard.ZstdDecompressor().decompress(
            frame, max_output_size=1 << 24)
        assert zstd.decompress(frame) == want


def test_zstd_corrupt_input_raises():
    rng = np.random.default_rng(2)
    data = rng.standard_normal(30_000).astype(np.float32).tobytes() \
        + bytes(20_000)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True) \
        .compress(data)
    cases = {
        "magic": b"\x00" + frame[1:],
        "checksum": frame[:-1] + bytes([frame[-1] ^ 1]),
        "reserved_bit": frame[:4] + bytes([frame[4] | 8]) + frame[5:],
        "trailing": frame + b"\x28\xb5",
    }
    cases.update({f"truncated_{n}": frame[:n]
                  for n in range(0, len(frame), max(1, len(frame) // 40))})
    for name, bad in cases.items():
        with pytest.raises(zstd.ZstdError):
            decode(bad, len(data))
        assert name  # every case raised
    # the same frame naming dictionary 7: a one-byte Dictionary_ID after
    # the window descriptor
    fhd = frame[4]
    at = 6 if not fhd & 0x20 else 5
    with_dict = frame[:4] + bytes([fhd | 1]) + frame[5:at] + b"\x07" \
        + frame[at:]
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        decode(with_dict, len(data))
    with pytest.raises(zstd.ZstdError, match="capacity"):
        decode(frame, len(data) - 1)


def test_zstd_byte_flips_raise_or_change_nothing():
    """With a checksum, a flipped byte either raises or (a window
    descriptor, unused padding) leaves the output as it was."""
    rng = np.random.default_rng(3)
    data = (rng.standard_normal(12_000).astype(np.float32).tobytes()
            + b"gigagan" * 3000)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True) \
        .compress(data)
    raised = 0
    for _ in range(400):
        bad = bytearray(frame)
        i = int(rng.integers(0, len(bad)))
        bad[i] ^= int(rng.integers(1, 256))
        try:
            out = decode(bytes(bad), len(data))
        except zstd.ZstdError:
            raised += 1
        else:
            assert out == data, i
    assert raised > 350


def test_crc32c():
    def slow(data):
        c = 0xFFFFFFFF
        for b in data:
            c ^= b
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        return c ^ 0xFFFFFFFF

    assert zstd.crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(4)
    for n in (0, 1, 7, 8, 9, 63, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert zstd.crc32c(data) == slow(data)


def test_build_needs_cc_and_reports_its_errors(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    shutil.copy(build.CSRC_DIR / "zstd_decode.c", csrc)
    (csrc / "broken.c").write_text("int f(void) { return }\n")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="cc failed for broken.c"):
        build.build("broken")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="cc not found"):
        build.build("zstd_decode")


# ----------------------------------------------------------------- OCDBT


def assert_matches_tensorstore(root):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{Path(root).resolve()}/"}).result()
    want = sorted(k.decode() for k in kv.list().result())
    db = OcdbtReader(root)
    assert db.keys() == want
    for key in want:
        assert db.read(key) == bytes(kv.read(key).result().value), key
    return len(want)


def test_ocdbt_reads_the_fixture():
    # 318 arrays, each a .zarray and one chunk
    assert assert_matches_tensorstore(ORBAX_CKPT) == 2 * 318


TS_CONFIGS = {
    # interior nodes three levels deep, indirect values, 2 inline versions
    # and older ones in version-tree nodes
    "interior": dict(max_decoded_node_bytes=600, max_inline_value_bytes=20,
                     version_tree_arity_log2=1),
    "uncompressed": dict(compression=None, max_decoded_node_bytes=300),
    "zstd_level_5": dict(compression={"id": "zstd", "level": 5}),
    "numbered": dict(manifest_kind="numbered", max_decoded_node_bytes=300),
}


@pytest.mark.parametrize("name", list(TS_CONFIGS))
def test_ocdbt_reads_what_tensorstore_writes(tmp_path, name):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": TS_CONFIGS[name]}).result()
    rng = np.random.default_rng(5)
    for commit in range(5):
        with ts.Transaction() as txn:
            kvt = kv.with_transaction(txn)
            for i in range(60):
                size = int(rng.integers(0, 2000))
                kvt[f"key/{commit}/{i:04d}"] = rng.integers(
                    0, 256, size, dtype=np.uint8).tobytes()
            if commit:  # a later version overwrites and deletes
                kvt[f"key/{commit - 1}/0001"] = b"overwritten"
                del kvt[f"key/{commit - 1}/0002"]
    n = assert_matches_tensorstore(tmp_path)
    assert n == 5 * 60 - 4
    db = OcdbtReader(tmp_path)
    assert db.read("key/0/0001") == b"overwritten"
    assert "key/0/0002" not in db


def test_ocdbt_reads_a_multi_process_merge(tmp_path):
    """A multi-host save as orbax merges it (``ocdbt_utils.
    merge_ocdbt_per_process_files``): each process writes its own database
    under ``ocdbt.process_N/``, then the top-level one takes their ranges
    (``experimental_copy_range_to``), its leaves pointing into the
    processes' data files through base paths.  Small nodes give both
    levels interior nodes."""
    ctx = ts.Context()
    small = {"max_decoded_node_bytes": 500, "max_inline_value_bytes": 20}
    rng = np.random.default_rng(8)
    children = []
    for proc in range(3):
        kv = ts.KvStore.open({"driver": "ocdbt", "config": small, "base": {
            "driver": "file", "path": f"{tmp_path}/ocdbt.process_{proc}"}},
            context=ctx).result()
        with ts.Transaction() as txn:
            for i in range(60):
                kv.with_transaction(txn)[f"p{proc}.w{i:03d}/0"] = \
                    rng.integers(0, 256, int(rng.integers(1, 300)),
                                 dtype=np.uint8).tobytes()
        children.append(kv)
    parent = ts.KvStore.open({
        "driver": "ocdbt", "base": {"driver": "file", "path": str(tmp_path)},
        "config": {**small, "manifest_kind": "single"},
        "assume_config": True}, context=ctx).result()
    txn = ts.Transaction(atomic=True)
    for child in children:
        child.experimental_copy_range_to(parent.with_transaction(txn)) \
            .result()
    txn.commit_async().result()
    assert assert_matches_tensorstore(tmp_path) == 3 * 60
    db = OcdbtReader(tmp_path)
    dirs = {value[0].relative_to(tmp_path).parts[0]
            for value in db._values.values() if not isinstance(value, bytes)}
    assert dirs == {f"ocdbt.process_{proc}" for proc in range(3)}


def test_ocdbt_corrupt_node_raises(tmp_path):
    root = tmp_path / "ckpt"
    shutil.copytree(ORBAX_CKPT, root)
    node = next(p for p in (root / "d").iterdir())
    raw = bytearray(node.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    node.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C"):
        OcdbtReader(root)


# ------------------------------------------------------------------ zarr


ZARR_DTYPES = ["<f4", "<f2", "<f8", "<i4", "<i8", "<u4", "|u1", "|b1",
               ">i4", "bfloat16"]


@pytest.mark.parametrize("store", ["file", "ocdbt"])
@pytest.mark.parametrize("compressor", [{"id": "zstd", "level": 3}, None],
                         ids=["zstd", "raw"])
@pytest.mark.parametrize("dtype", ZARR_DTYPES)
def test_zarr_matches_tensorstore(tmp_path, dtype, compressor, store):
    """Ragged edge chunks (10 x 15 in 4 x 7 chunks) and missing chunks,
    which hold the fill value."""
    if store == "file":
        kvstore = {"driver": "file", "path": f"{tmp_path}/arr/"}
    else:
        kvstore = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
                   "path": "arr/"}
    fill = False if dtype == "|b1" else 3
    spec = {"driver": "zarr", "kvstore": kvstore,
            "metadata": {"shape": [10, 15], "chunks": [4, 7], "dtype": dtype,
                         "compressor": compressor, "fill_value": fill}}
    arr = ts.open(spec, create=True).result()
    rng = np.random.default_rng(6)
    values = rng.standard_normal((6, 9)) * 50
    arr[0:6, 2:11] = values.astype(arr.dtype.numpy_dtype)
    want = ts.open(spec).result().read().result()
    if store == "file":
        def get(key):
            f = tmp_path / key
            return f.read_bytes() if f.is_file() else None
    else:
        db = OcdbtReader(tmp_path)

        def get(key):
            return db.read(key) if key in db else None
    got = orbax_checkpoint.read_zarr(get, "arr")
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    else:
        assert got.numpy().dtype == np.dtype(dtype).newbyteorder("=")
        np.testing.assert_array_equal(got.numpy(), want)


def test_zarr3_and_other_codecs_raise(tmp_path):
    root = tmp_path / "ckpt"
    shutil.copytree(ORBAX_CKPT, root)
    meta = json.loads((root / "_METADATA").read_text())
    (root / "_METADATA").write_text(json.dumps({**meta, "use_zarr3": True}))
    with pytest.raises(NotImplementedError, match="zarr3"):
        orbax_checkpoint.restore(root)
    zarray = {"chunks": [2], "compressor": {"id": "blosc"}, "dtype": "<f4",
              "fill_value": None, "filters": None, "order": "C",
              "shape": [2], "zarr_format": 2}
    store = {"a/.zarray": json.dumps(zarray).encode()}
    with pytest.raises(NotImplementedError, match="blosc"):
        orbax_checkpoint.read_zarr(store.get, "a")


# --------------------------------------------------------------- payload


def jax_read(path):
    """The JAX trainer's own reader of an orbax checkpoint."""
    trainer = types.SimpleNamespace(checkpoint_backend="orbax")
    return JaxGigaGAN._read_checkpoint(trainer, Path(path))


def assert_same_leaves(ours, theirs, path="root"):
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and set(ours) == set(theirs), path
        for k in theirs:
            assert_same_leaves(ours[k], theirs[k], f"{path}/{k}")
    elif hasattr(theirs, "dtype") and hasattr(theirs, "shape"):
        want = np.asarray(theirs)
        assert torch.is_tensor(ours), path
        assert str(ours.dtype).removeprefix("torch.") == want.dtype.name, path
        assert tuple(ours.shape) == want.shape, path
        if want.dtype.name == "bfloat16":
            ours, want = ours.view(torch.int16), want.view(np.int16)
        assert np.array_equal(ours.numpy(), want), path
    else:
        assert type(ours) is type(theirs) and ours == theirs, path


def assert_payload_matches_jax(path):
    state, rng, version = jax_read(path)
    payload = jax_checkpoint.read_checkpoint(path)
    assert set(payload) == {"state", "rng", "version"}
    assert payload["version"] == version
    assert_same_leaves(payload["state"], state, "state")
    assert_same_leaves(payload["rng"], rng, "rng")
    return payload


def test_payload_of_the_fixture():
    payload = assert_payload_matches_jax(ORBAX_CKPT)
    assert payload["version"] is not None
    # optax's empty states and the absent vision-aided D come back as the
    # msgpack reader gives them
    msgpack = jax_checkpoint.read_checkpoint(FIXTURES / "jax_model"
                                             / "model-1.ckpt")
    assert_same_leaves(payload["state"], _as_numpy(msgpack["state"]))
    assert payload["state"]["g_opt"]["1"] == {}
    assert payload["state"]["vd_params"] is None


def _as_numpy(tree):
    """A port payload's tensors as numpy arrays (bf16 as ml_dtypes')."""
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        if tree.dtype == torch.bfloat16:
            import ml_dtypes

            return tree.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return tree.numpy()
    return tree


@pytest.fixture(scope="module")
def fixture_payload():
    state, rng, _ = jax_read(ORBAX_CKPT)
    return {"state": state, "rng": rng}


def _save(path, tree, **kwargs):
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(Path(path).resolve(), tree, **kwargs)


def test_payload_of_a_multi_chunk_save(tmp_path, fixture_payload):
    import jax

    path = tmp_path / "model-1.ckpt"
    save_args = jax.tree.map(lambda _: ocp.SaveArgs(chunk_byte_size=64),
                             fixture_payload)
    _save(path, fixture_payload, save_args=save_args)
    (path / "VERSION").write_text("0.1.0")
    keys = OcdbtReader(path).keys()
    arrays = [k for k in keys if k.endswith("/.zarray")]
    assert len(keys) - len(arrays) > 4 * len(arrays)  # chunks
    assert assert_payload_matches_jax(path)["version"] == "0.1.0"


def test_payload_of_a_save_without_ocdbt(tmp_path, fixture_payload):
    path = tmp_path / "model-1.ckpt"
    handler = ocp.PyTreeCheckpointHandler(use_ocdbt=False)
    with ocp.Checkpointer(handler) as ckptr:
        ckptr.save(path.resolve(), args=ocp.args.PyTreeSave(fixture_payload))
    assert not (path / "manifest.ocdbt").exists()
    assert (path / "rng" / ".zarray").is_file()
    assert_payload_matches_jax(path)


def test_payload_of_the_bare_state_layout(tmp_path, fixture_payload):
    path = tmp_path / "model-1.ckpt"
    _save(path, fixture_payload["state"])
    payload = assert_payload_matches_jax(path)
    assert payload["rng"] is None and "g_params" in payload["state"]


def test_payload_of_scalars_and_empties(tmp_path):
    """Python numbers (``scalar``), None, empty dicts and bools come back
    as orbax restores them; a list or tuple, which no GigaGAN state holds,
    raises."""
    tree = {"d": {}, "n": None, "s": 3.5, "i": 7,
            "a": {"b": np.array([True, False]), "x": np.arange(3)}}
    _save(tmp_path / "c", tree)
    state, _, _ = jax_read(tmp_path / "c")
    payload = jax_checkpoint.read_checkpoint(tmp_path / "c")
    assert_same_leaves(payload["state"], state)
    _save(tmp_path / "no_arrays", {"n": None, "d": {}})  # no OCDBT at all
    assert_same_leaves(
        jax_checkpoint.read_checkpoint(tmp_path / "no_arrays")["state"],
        jax_read(tmp_path / "no_arrays")[0])
    for i, seq in enumerate(([np.ones(2, np.float32)], {"e": []},
                             {"t": ()})):
        _save(tmp_path / f"seq{i}", {"a": seq})
        with pytest.raises(NotImplementedError):
            jax_checkpoint.read_checkpoint(tmp_path / f"seq{i}")


@pytest.fixture(scope="module")
def quickstart_ckpt(tmp_path_factory):
    """The JAX trainer's orbax save of a quickstart-depth state (803
    leaves), narrow."""
    root = tmp_path_factory.mktemp("quickstart")
    gan = JaxGigaGAN(**QUICKSTART_NARROW, model_folder=str(root),
                     results_folder=str(root / "results"),
                     checkpoint_backend="orbax")
    gan.save(root / "model-0.ckpt")
    return root / "model-0.ckpt"


def test_quickstart_depth_ocdbt_matches_tensorstore(quickstart_ckpt):
    meta = json.loads((quickstart_ckpt / "_METADATA").read_text())
    assert len(meta["tree_metadata"]) > 800
    assert assert_matches_tensorstore(quickstart_ckpt) > 1500


def test_quickstart_depth_payload_matches_jax(quickstart_ckpt):
    assert_payload_matches_jax(quickstart_ckpt)


# ---------------------------------------------------------------- loading


def _load(folder):
    gan, ckpt = cli._load_model_folder(folder, "cpu")
    return gan, ckpt


def test_load_of_the_orbax_folder_equals_the_msgpack_folder():
    orbax, ckpt = _load(FIXTURES / "jax_model_orbax")
    assert ckpt.is_dir()
    msgpack, _ = _load(FIXTURES / "jax_model")
    assert orbax.steps == msgpack.steps == 3
    for key in ("G", "G_ema", "D"):
        a = getattr(orbax, key).state_dict()
        b = getattr(msgpack, key).state_dict()
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name], b[name]), f"{key}.{name}"
    for key in ("g_opt", "d_opt"):
        a = getattr(orbax, key).state_dict()["state"]
        b = getattr(msgpack, key).state_dict()["state"]
        assert a.keys() == b.keys() and a
        for i in a:
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(a[i][k], b[i][k]), f"{key}[{i}].{k}"
    assert (orbax.ema.step, orbax.ema.initted) == (msgpack.ema.step,
                                                   msgpack.ema.initted)


def test_load_jax_checkpoint_takes_the_directory():
    gan, _ = _load(FIXTURES / "jax_model")
    gan.load_jax_checkpoint(ORBAX_CKPT, strict=True)
    assert gan.steps == 3


def port_generator_out(module, latents, noises):
    it = iter(noises)

    def hook(mod, args, kwargs):
        return args, dict(kwargs, noise=torch.from_numpy(next(it)))

    hooks = [m.register_forward_pre_hook(hook, with_kwargs=True)
             for m in module.modules() if isinstance(m, tl.Noise)]
    with torch.no_grad():
        out = module(noise=torch.from_numpy(latents))
    for h in hooks:
        h.remove()
    return out.numpy()


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def test_generate_from_the_orbax_folder(tmp_path):
    folder = tmp_path / "jax_model_orbax"
    shutil.copytree(FIXTURES / "jax_model_orbax", folder)
    out = tmp_path / "grid.png"
    rc = cli.main(["generate", "--models", str(folder), "--num", "4",
                   "--seed", "0", "--out", str(out), "--device", "cpu"])
    assert rc == 0
    assert png.decode_png(out.read_bytes()).shape == (38, 38, 3)
    gan, _ = _load(folder)
    outs = FIXTURES / "jax_outputs"
    latents = np.load(outs / "latents.npy")
    noises = [np.load(p) for p in sorted(outs.glob("noise_*.npy"))]
    for module, name in ((gan.G, "g"), (gan.G_ema, "g_ema")):
        got = port_generator_out(module, latents, noises)
        assert rel_err(got, np.load(outs / f"{name}.npy")) <= JAX_OUT_TOL


def test_resume_onto_an_orbax_directory_raises(tmp_path, capsys):
    """Resumed from the orbax folder at step 3, the first step saves
    milestone 4 // 3 = 1: ``model-1.ckpt``, the orbax directory itself."""
    folder = tmp_path / "jax_model_orbax"
    shutil.copytree(FIXTURES / "jax_model_orbax", folder)
    before = sorted(p.relative_to(folder) for p in folder.rglob("*"))
    with pytest.raises(FileExistsError, match="model-1.ckpt"):
        cli.main(["train", "--config", str(folder / "config.json"),
                  "--mock-data", "--batch-size", "8", "--steps", "1",
                  "--save-every", "3", "--models", str(folder),
                  "--results", str(tmp_path / "results"), "--device", "cpu",
                  "--resume"])
    assert f"resuming from {folder / 'model-1.ckpt'}" in \
        capsys.readouterr().out
    assert sorted(p.relative_to(folder) for p in folder.rglob("*")) == before
    assert jax_checkpoint.read_checkpoint(folder / "model-1.ckpt")


def test_reading_loads_no_jax_orbax_or_zstd_library():
    code = (
        "import sys\n"
        "from gigagan_tpu_torch.train import jax_checkpoint\n"
        f"p = jax_checkpoint.read_checkpoint({str(ORBAX_CKPT)!r})\n"
        "assert p['state']['g_params']\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ("
        "'jax', 'flax', 'optax', 'orbax', 'tensorstore', 'zstandard', "
        "'xxhash', 'msgpack', 'ml_dtypes', 'gigagan_tpu')]\n"
        "assert not bad, bad\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libzstd' not in maps\n"
        "assert 'zstd_decode-' in maps\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------ full width


def _cpu_name():
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        if line.startswith("model name"):
            return line.split(":", 1)[1].strip()
    return "unknown CPU"


@pytest.mark.slow
def test_full_width_state(tmp_path):
    """The quickstart's full-width state, 1.14 GiB: the port's quickstart
    G and D parameter shapes in the JAX state's layout (params, EMA and two
    Adam moments for G; params and moments for D), random fp32, saved by
    orbax as the JAX trainer saves and by flax's msgpack; the port reads
    both, bitwise as orbax restores, and prints the times."""
    from flax import serialization

    from gigagan_tpu_torch import GigaGAN
    from gigagan_tpu_torch.cli import _default_train_config

    args = types.SimpleNamespace(cmd="train", image_size=256)
    cfg = _default_train_config(args)
    gan = GigaGAN(generator=cfg["generator"],
                  discriminator=cfg["discriminator"], amp=True,
                  device="cpu", model_folder=str(tmp_path / "m"),
                  results_folder=str(tmp_path / "r"))
    rng = np.random.default_rng(7)

    def tree(module):
        out = {}
        for name, p in module.state_dict().items():
            node = out
            *parents, leaf = name.split(".")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = (rng.standard_normal(p.shape, np.float32)
                          * 0.02).astype(np.float32)
        return out

    state = {"g_params": tree(gan.G), "ema": {"params": tree(gan.G)},
             "d_params": tree(gan.D),
             "g_opt": {"mu": tree(gan.G), "nu": tree(gan.G)},
             "d_opt": {"mu": tree(gan.D), "nu": tree(gan.D)},
             "steps": np.asarray(1000, np.int32)}
    del gan
    payload = {"state": state, "rng": np.array([0, 42], np.uint32)}
    nbytes = sum(v.nbytes for _, v in _leaves(payload["state"]))
    path = tmp_path / "model-1.ckpt"
    _save(path, payload)
    (path / "VERSION").write_text("0.1.0")
    msgpack_path = tmp_path / "model-1.msgpack"
    msgpack_path.write_bytes(serialization.msgpack_serialize(
        {**payload, "version": "0.1.0"}))
    del payload, state

    t0 = time.perf_counter()
    got = jax_checkpoint.read_checkpoint(path)
    orbax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax_checkpoint.read_checkpoint(msgpack_path)
    msgpack_s = time.perf_counter() - t0
    db = OcdbtReader(path)
    frames = [db.read(k) for k in db.keys() if not k.endswith(".zarray")]
    out = np.empty(max(f.nbytes for _, f in _leaves(got["state"])
                       if torch.is_tensor(f)), np.uint8)
    t0 = time.perf_counter()
    decoded = sum(zstd.decompress_into(f, out) for f in frames)
    decode_s = time.perf_counter() - t0
    print(f"\nfull-width state {nbytes / 2 ** 30:.3f} GiB on {_cpu_name()}: "
          f"orbax import {orbax_s:.2f} s, msgpack import {msgpack_s:.2f} s, "
          f"zstd decode {decoded / decode_s / 1e6:.0f} MB/s of output "
          f"({decoded} bytes in {decode_s:.2f} s, one thread)")
    assert decoded / decode_s >= 200e6
    state, rng, _ = jax_read(path)
    assert_same_leaves(got["state"], state, "state")
    assert_same_leaves(got["rng"], rng, "rng")
