"""Builds the hand-written CUDA kernels under ``gigagan_tpu_torch/csrc`` and
loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds) under ``gigagan_tpu_torch/_build/``,
keyed by a hash of the source, the shared ``csrc/*.cuh`` headers and the
flags; ``build_all`` starts one nvcc per source at once.  Nothing here runs when a
module is imported: the CPU tests import every module on machines without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from source at first use"
        )
    return found


KERNELS = (
    "adaptive_conv_fwd",
    "adaptive_conv_fwd_tc",
    "adaptive_conv_bwd_w",
    "adaptive_conv_bwd_w_tc",
    "flash_attention_fused_fwd",
    "flash_attention_fused_fwd_tc",
    "flash_attention_fused_bwd",
    "flash_attention_fused_bwd_tc",
    "flash_attention_so_bwd2",
    "flash_attention_so_bwd2_tc",
    "flash_attention_fwd",
    "flash_attention_bwd",
    "flash_attention_hv_jvp",
    "flash_attention_hv_jvp_tc",
    "flash_attention_hv_bwd",
    "flash_attention_hv_bwd_tc",
)


def _digest(src: pathlib.Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str, verbose: bool = False) -> tuple[pathlib.Path, str]:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.
    Returns (library path, compiler log); ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel) to a fresh build."""
    src = CSRC_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"{name}-{_digest(src)}.so"
    if lib.exists() and not verbose:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def build_all(verbose: bool = False) -> dict:
    """Build every kernel, one nvcc process each, all at once.
    Returns {name: (library path, compiler log, seconds)}."""

    def one(name):
        t0 = time.perf_counter()
        path, log = build(name, verbose=verbose)
        return name, (path, log, time.perf_counter() - t0)

    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        return dict(pool.map(one, KERNELS))


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first call)."""
    with _LOCK:
        if name not in _LIBS:
            path, _ = build(name)
            _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero cudaError_t."""
    if err != 0:
        lib.gigagan_cuda_error_string.restype = ctypes.c_char_p
        msg = lib.gigagan_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
