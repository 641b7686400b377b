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
that it went through the kernels; ``FLASH_VARIANTS`` splits the flash
kernel's count by variant, ``TOPK_VARIANTS`` the top-k kernel's (one
warp per block, or one CTA per row); ``reset_launches`` zeroes the
counts. ``LIBRARY_EVENTS`` counts this process's builds and loads of the
library (``analysis.runtime.RecompileWatcher`` reads them).

``launch_on`` is the wrappers' one way in: it calls a C entry point on
the current stream of the tensors' card, entering that card's context
only when it is not the current one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_HERE, "csrc", name)
                for name in ("wire_kernels.cu", "flash_attention.cu",
                             "optim_kernels.cu"))
#: src/repro_torch/kernels -> the checkout root, three levels up
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
BUILD_ROOT = os.path.join(_REPO_ROOT, "build", "repro_torch_kernels")
#: no --use_fast_math: the kernels need div.rn.f32 and the accurate
#: expf / tanhf (see the .cu headers). ``-Xptxas -v`` reports each
#: kernel's registers, shared memory and spills: the build keeps the
#: report beside the library (``ptxas_report``).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"quantize_blocks": 0, "dequantize_blocks": 0,
                            "quantize_topk_blocks": 0, "masked_sum_limbs": 0,
                            "masked_sum_u64": 0, "flash_attention_bhsd": 0,
                            "adamw_update": 0}
#: the flash kernel's launches by variant (``flash_attention.VARIANTS``)
FLASH_VARIANTS: Dict[str, int] = {"mma_bf16": 0, "rows_f32": 0,
                                  "tiled_f32": 0}
#: the top-k kernel's launches by kernel (``wire.quantize_topk_blocks``)
TOPK_VARIANTS: Dict[str, int] = {"warp": 0, "cta": 0}
#: builds (``_build``) and loads (``load_library``) of the kernel library
LIBRARY_EVENTS: Dict[str, int] = {"builds": 0, "loads": 0}

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
    # x, codes, scales, mask, n_blocks, block, bits, inv, k, warp, stream
    "quantize_topk_blocks_launch": [_VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT,
                                    _INT, _INT, _FLOAT, _INT, _INT, _VOIDP],
    # hi, lo, hi_out, lo_out, rows, n, stream
    "masked_sum_limbs_launch": [_VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT, _INT64,
                                _VOIDP],
    # vals, out, rows, n, stream
    "masked_sum_u64_launch": [_VOIDP, _VOIDP, _INT, _INT64, _VOIDP],
    # the packed FlashArgs (flash_attention._ARGS), stream
    "flash_attention_bhsd_launch": [ctypes.c_char_p, _VOIDP],
    # g, p, mu, nu, mask, bc1, bc2, n, mask_inner, g / p / moment dtypes,
    # b1, 1 - b1, b2, 1 - b2, eps, weight_decay, -lr, decay, stream
    "adamw_update_launch": [_VOIDP] * 7 + [_INT64, _INT64, _INT, _INT, _INT]
                           + [_FLOAT] * 7 + [_INT, _VOIDP],
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for counts in (LAUNCHES, FLASH_VARIANTS, TOPK_VARIANTS):
        for name in counts:
            counts[name] = 0


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


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _build(out: str) -> None:
    LIBRARY_EVENTS["builds"] += 1
    os.makedirs(os.path.dirname(out), exist_ok=True)
    nvcc = _nvcc()
    # every name is temporary and renamed at the end, so a concurrent or
    # interrupted build never leaves a half-written library behind
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in SOURCES]
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            reports = list(pool.map(
                _run, [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                       for src, obj in zip(SOURCES, objs)]))
        lib = os.path.join(tmp, "lib.so")
        _run([nvcc, "-shared", "-o", lib, *objs])
        report = os.path.join(tmp, "ptxas.txt")
        with open(report, "w") as f:
            f.write("".join(reports))
        os.replace(report, _report_path(out))
        os.replace(lib, out)


def _report_path(lib: str) -> str:
    return os.path.join(os.path.dirname(lib), "ptxas.txt")


def ptxas_report() -> List[dict]:
    """Each kernel's registers, spill bytes and static shared memory as
    ptxas reported them when the library was built (``[]`` if it was
    built elsewhere)."""
    path = _report_path(library_path())
    if not os.path.exists(path):
        return []
    rows, row = [], None
    with open(path) as f:
        for line in f:
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                row = {"kernel": entry.group(1)}
                rows.append(row)
            elif row is not None:
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", line)
                used = re.search(r"Used (\d+) registers", line)
                smem = re.search(r"(\d+) bytes smem", line)
                if spill:
                    row["spill_stores"] = int(spill.group(1))
                    row["spill_loads"] = int(spill.group(2))
                if used:
                    row["registers"] = int(used.group(1))
                if smem:
                    row["static_smem"] = int(smem.group(1))
    return rows


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
    LIBRARY_EVENTS["loads"] += 1
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


#: the current stream's handle of a card, without building a Stream
#: object (CUDA builds of torch have it; the fallback is the public call)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(index: int) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch_on(index: int, name: str, *args) -> int:
    """Call the C entry point ``name`` with ``args`` and the current
    stream of card ``index``; returns its cudaError_t. (The card's tensors
    exist, so CUDA is initialised and the current device can be read
    directly.)"""
    fn = getattr(load_library(), name)
    if index == torch._C._cuda_getDevice():
        return fn(*args, current_stream(index))
    with torch.cuda.device(index):
        return fn(*args, current_stream(index))
