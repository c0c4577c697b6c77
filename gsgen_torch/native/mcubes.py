"""Isosurface extraction for the mesh export, through a small C++ library.

The port's own copy of the JAX package's native marching tetrahedra
(``native/mcubes.cpp`` here).  It is built with ``g++`` at first use into
``gsgen_torch/_build/`` (rebuilt when the source is newer) and bound with
``ctypes``; nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "mcubes.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"

_lib = None


def build() -> Path:
    """Compile ``mcubes.cpp`` into ``_build/libgsgen_mcubes.so``."""
    so = BUILD / "libgsgen_mcubes.so"
    if so.exists() and so.stat().st_mtime >= SRC.stat().st_mtime:
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(".so.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           str(SRC), "-o", str(tmp)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{done.stderr}")
    tmp.replace(so)
    return so


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.mt_marching_tetrahedra.restype = ctypes.c_int
        lib.mt_marching_tetrahedra.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
    return _lib


def marching_cubes(grid: np.ndarray, iso: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface of a [nx, ny, nz] float grid: (verts [V, 3] float32 in
    grid-index units, faces [F, 3] int32).  The output buffers grow
    fourfold until the mesh fits."""
    lib = _get_lib()
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    nx, ny, nz = grid.shape
    cap_v = max(1 << 16, nx * ny * 4)
    cap_f = cap_v * 2
    while True:
        verts = np.empty((cap_v, 3), np.float32)
        faces = np.empty((cap_f, 3), np.int32)
        nv = ctypes.c_int64()
        nf = ctypes.c_int64()
        rc = lib.mt_marching_tetrahedra(
            grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            nx, ny, nz, ctypes.c_float(iso),
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap_v,
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap_f,
            ctypes.byref(nv), ctypes.byref(nf))
        if rc == 0:
            return verts[:nv.value].copy(), faces[:nf.value].copy()
        cap_v *= 4
        cap_f *= 4
