"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` to an object, all of them at once
(one ``nvcc`` process per source), and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``, at
first use, into ``build/repro_torch_kernels/<hash>/`` under the checkout
(keyed on a hash of the sources and the flags, so an edit rebuilds).
Nothing is compiled or loaded at import time: this module imports on a
machine without CUDA.

``LAUNCHES`` counts the launches of each kernel. Each kernel wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that it went through the kernels; ``reset_launches`` zeroes the counts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_HERE, "csrc", name)
                for name in ("wire_kernels.cu", "flash_attention.cu"))
#: src/repro_torch/kernels -> the checkout root, three levels up
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
BUILD_ROOT = os.path.join(_REPO_ROOT, "build", "repro_torch_kernels")
#: no --use_fast_math: the kernels need div.rn.f32 and the accurate
#: expf / tanhf (see the .cu headers)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {"quantize_blocks": 0, "dequantize_blocks": 0,
                            "quantize_topk_blocks": 0, "masked_sum_limbs": 0,
                            "flash_attention_bhsd": 0}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
_INT64 = ctypes.c_int64
_SIGNATURES = {
    # x, codes, scales, n_blocks, block, bits, inv, stream
    "quantize_blocks_launch": [_VOIDP, _VOIDP, _VOIDP, _INT, _INT, _INT,
                               _FLOAT, _VOIDP],
    # codes, scales, out, n_blocks, block, stream
    "dequantize_blocks_launch": [_VOIDP, _VOIDP, _VOIDP, _INT, _INT, _VOIDP],
    # x, codes, scales, mask, n_blocks, block, bits, inv, k, stream
    "quantize_topk_blocks_launch": [_VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT,
                                    _INT, _INT, _FLOAT, _INT, _VOIDP],
    # hi, lo, hi_out, lo_out, rows, n, stream
    "masked_sum_limbs_launch": [_VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT, _INT64,
                                _VOIDP],
    # q, k, v, o, dtype, batch, heads, kv_heads, sq, sk, d, strides[12],
    # scale, causal, window, softcap, stream
    "flash_attention_bhsd_launch": [_VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT,
                                    _INT, _INT, _INT, _INT, _INT, _INT,
                                    ctypes.POINTER(ctypes.c_longlong), _FLOAT,
                                    _INT, _INT, _FLOAT, _VOIDP],
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    """``nvcc`` on ``PATH``, else under the toolkit PyTorch finds
    (``CUDA_HOME``, ``CUDA_PATH`` or the default install)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME to build the CUDA kernels")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_ROOT, digest.hexdigest()[:16],
                        "librepro_torch_kernels.so")


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")


def _build(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    nvcc = _nvcc()
    # every name is temporary and renamed at the end, so a concurrent or
    # interrupted build never leaves a half-written library behind
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in SOURCES]
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            list(pool.map(_run, [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                                 for src, obj in zip(SOURCES, objs)]))
        lib = os.path.join(tmp, "lib.so")
        _run([nvcc, "-shared", "-o", lib, *objs])
        os.replace(lib, out)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library, once per
    process."""
    global _lib
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    out = library_path()
    if not os.path.exists(out):
        _build(out)
    lib = ctypes.CDLL(out)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT
    _lib = lib
    return lib


def check_cuda_tensor(t: torch.Tensor, dtype: torch.dtype, ndim: int,
                      what: str) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def check_launch(err: int, name: str) -> None:
    """Raise on a refused launch (the C entry points return
    cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
