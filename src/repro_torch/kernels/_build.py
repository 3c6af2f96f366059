"""Builds the hand-written CUDA kernels and loads them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` (all started
together) into an object, and the objects are linked into one shared
library with a plain C interface.  The library lands in ``build/`` next
to this file (listed in ``.gitignore``) under a name that hashes the
sources and flags, so an edit to a source rebuilds and an unchanged
checkout loads what it built before.  Nothing here runs at import: the
first kernel launch calls :func:`load`.  The wrappers' shared checks on
the tensors they hand over as raw pointers live here too.

No ``--use_fast_math`` and no ``-ftz=true``: the kernels must compare,
divide and take square roots exactly as IEEE float32 does, or the
survivor sets (and so the wire-bit ledger) drift from the plain
versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float
#: the C entry points and their argument types (pointers and the stream
#: as void*, so ctypes never narrows them to 32 bits)
SIGNATURES = {
    # acc, sel, mem, cnt, rows, n, k, iters, sign, stream
    "qs_topk_compress_f32": [_P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                             _P],
    # x, u, out, rows, n, s, stream
    "qs_qsgd_quantize_f32": [_P, _P, _P, _I64, _I64, _I32, _P],
    # x, idx, val, out, M, R, n, kcap, x_bf16, stream
    "qs_sparse_gemm": [_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _P],
    # x, levels, scale, out, M, R, n, x_bf16, stream
    "qs_qdq_gemm": [_P, _P, _P, _P, _I32, _I32, _I32, _I32, _P],
    # q, kp, vp, kscale, vscale, tables, lengths, out, B, H, KV, hd,
    # n_pages, page_size, P, pages_per_block, scale, q_bf16, quant, stream
    "qs_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                        _I32, _I32, _I32, _I32, _I32, _F32, _I32, _I32, _P],
    # q, k, v, valid, out, B, H, KV, hd, C, scale, bf16, stream
    "qs_flash_decode": [_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                        _F32, _I32, _P],
    "qs_error_string": [_I32],
}

_LIB: Optional[ctypes.CDLL] = None


def sources() -> list:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (not on PATH, nor under $CUDA_HOME/bin); the "
            "CUDA kernels cannot be built")
    return path


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libqsparse_{_digest(sources())}.so")


def build() -> str:
    """Compile and link the kernels if this checkout has not yet; returns
    the library path."""
    target = library_path()
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = [s for s in sources() if s.endswith(".cu")]
        objs, procs = [], []
        for src in units:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *ARCH, *FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *ARCH, "-shared", *objs, "-o", tmp_lib],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, target)
    return target


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == "qs_error_string" \
                else ctypes.c_int
        _LIB = lib
    return _LIB


def check_tensor(name: str, t, ndim: int, dtypes) -> None:
    """Raise unless ``t`` has ``ndim`` dims, one of ``dtypes`` and a
    contiguous layout: the kernels index raw pointers."""
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_of(*ts):
    """The one device all of ``ts`` are on (the CPU or a CUDA card)."""
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev


def stream_of(dev) -> int:
    """The current CUDA stream of ``dev``, as the kernels take it."""
    import torch
    return torch.cuda.current_stream(dev).cuda_stream


def check(err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = load().qs_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({err})")
