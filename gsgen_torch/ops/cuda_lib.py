"""Build and load the hand-written CUDA kernels (``gsgen_torch/csrc``).

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into an object
file, all sources at once in parallel, and the objects link into one
shared library with a plain C interface, loaded with ``ctypes``.  The
build goes to ``gsgen_torch/_build/`` at first use and is reused while it
is newer than every source.  Nothing here runs at import time.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0.  The
TMA tensor maps of the wgmma kernels are encoded on the host with
``cuTensorMapEncodeTiled``, reached through the runtime's driver entry
point (``csrc/flash_attn_sm90.cuh``), so the library links no ``-lcuda``.
``--fmad=false`` keeps each multiply and add rounded on its own, as the
plain PyTorch versions round them, so the render kernels and their plain
versions differ only by summation order.  The sources in
:data:`FUSED_FMA_SOURCES` are compared with their plain versions at a
stated tolerance instead and keep nvcc's default fused multiply-add.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
LIB_NAME = "libgsgen_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# K5, K6 and K7: held to their plain versions at 1e-4 x max|value| in fp32
# and 2e-2 (K5) / 3e-2 (K6, K7) in bf16 (chip_smoke.py FLASH_TOL); the
# 3xTF32 convolution to an fp64 F.conv2d at 1e-5 x max|value|
FUSED_FMA_SOURCES = {"flash_attn_fwd.cu", "flash_attn_bwd.cu",
                     "conv_3xtf32.cu"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the kernel entries (all return cudaError_t as int)
SIGNATURES = {
    "gsgen_raster_fwd": [_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _F, _P],
    "gsgen_raster_bwd": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _F, _P],
    "gsgen_raster_fwd_compact": [_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _F, _P],
    "gsgen_raster_bwd_compact": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _F, _P],
    "gsgen_expansion_rank": [_P, _I, _P, _I, _P],
    "gsgen_gid_repack": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "gsgen_flash_attn_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                             _I, _P, _P],
    "gsgen_flash_attn_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _F, _I, _I, _I, _P],
    "gsgen_flash_attn_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _F, _I, _I, _I, _P],
    "gsgen_conv2d_3xtf32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def sources():
    return sorted(CSRC.glob("*.cu"))


def flags(src: Path) -> list:
    """nvcc flags for one source."""
    if src.name in FUSED_FMA_SOURCES:
        return list(NVCC_FLAGS)
    return [*NVCC_FLAGS, "--fmad=false"]


def _stale(lib: Path) -> bool:
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return lib.stat().st_mtime < newest


def build(force: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` per source, all started
    together) and link them into ``_build/libgsgen_kernels.so``.  Records
    the seconds taken and the ptxas report in :data:`build_info`."""
    lib = BUILD / LIB_NAME
    if not force and not _stale(lib):
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        obj = BUILD / (src.stem + ".o")
        cmd = [nvcc, *flags(src), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, objs = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        objs.append(str(obj))
    tmp = BUILD / (LIB_NAME + f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", *objs, "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    log = "\n".join(logs)
    (BUILD / "build.log").write_text(log)
    build_info.update(seconds=time.perf_counter() - t0, log=log)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if missing or stale)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.gsgen_error_string.argtypes = [ctypes.c_int]
        handle.gsgen_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry ``name`` with ``args`` and the current CUDA stream;
    raise if the launch reported an error."""
    handle = lib()
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(handle, name)(*args, stream)
    if code != 0:
        msg = handle.gsgen_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({code})")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int
          ) -> None:
    """Validate a kernel argument: CUDA, dtype, rank, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
