"""ctypes bindings of the host tile I/O (``tileio.cpp``; counterpart of
segtpu/native/__init__.py).

The library is built with ``g++`` at first use into
``segtpu_torch/native/build/`` (ignored by git); its name carries a hash of
the source and the flags, so an edited source is rebuilt and a stale build
never loads. A build that fails raises with the compiler's output. Only
where there is no ``g++`` at all does :func:`available` say False, and
:class:`segtpu_torch.tiles.ImageSlicer` then takes its NumPy paths, as
segtpu does on a machine without a compiler (segtpu/native/__init__.py:3-5).
Those NumPy paths (``split``, ``merge_numpy``) are the plain versions that
the tests hold these to. ``extract_tiles.calls`` and ``merge_tiles.calls``
count the native calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "tileio.cpp"
BUILD_DIR = SOURCE.parent / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib = None

_IP = ctypes.POINTER(ctypes.c_int)
_FP = ctypes.POINTER(ctypes.c_float)
_DP = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_INT = ctypes.c_int


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtileio-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``tileio.cpp`` unless this source is built already; returns
    the library's path. Raises ``RuntimeError`` with g++'s output on
    failure."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"tile I/O build failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            extract = [None, _INT, _INT, _INT, _IP, _IP, _INT, _INT, _INT, _INT, None]
            lib.tileio_extract_tiles_f32.argtypes = [_FP if a is None else a for a in extract]
            lib.tileio_extract_tiles_u8.argtypes = [_U8P if a is None else a for a in extract]
            lib.tileio_merge_f32.argtypes = [_FP, _IP, _IP, _INT, _INT, _INT, _DP, _INT, _INT,
                                             _DP, _DP]
            for fn in (lib.tileio_extract_tiles_f32, lib.tileio_extract_tiles_u8,
                       lib.tileio_merge_f32):
                fn.restype = None
            _lib = lib
        return _lib


def available() -> bool:
    """True when the library is loaded or builds here; False only when there
    is no ``g++`` to build it. A failed build raises."""
    try:
        _library()
    except FileNotFoundError:
        return False
    return True


def _int32(values: Sequence[int]) -> np.ndarray:
    return np.ascontiguousarray(values, dtype=np.int32)


def extract_tiles(image: np.ndarray, xs: Sequence[int], ys: Sequence[int], tile: int,
                  m_top: int, m_left: int) -> np.ndarray:
    """All tiles ``(n, tile, tile, C)`` of the UNPADDED HWC (or HW) image at
    the crop origins ``xs``, ``ys`` of its reflect-101 padded frame (margins
    ``m_top``, ``m_left``), read through virtual borders. uint8 or
    float32."""
    if image.ndim == 2:
        image = image[..., None]
    image = np.ascontiguousarray(image)
    h, w, c = image.shape
    xs, ys = _int32(xs), _int32(ys)
    out = np.empty((len(xs), tile, tile, c), dtype=image.dtype)
    if image.dtype == np.float32:
        fn, ptr = _library().tileio_extract_tiles_f32, _FP
    elif image.dtype == np.uint8:
        fn, ptr = _library().tileio_extract_tiles_u8, _U8P
    else:
        raise TypeError(f"extract_tiles takes uint8 or float32 images, got {image.dtype}")
    fn(image.ctypes.data_as(ptr), h, w, c, xs.ctypes.data_as(_IP), ys.ctypes.data_as(_IP),
       len(xs), tile, m_top, m_left, out.ctypes.data_as(ptr))
    extract_tiles.calls += 1
    return out


extract_tiles.calls = 0


def merge_tiles(tiles: np.ndarray, xs: Sequence[int], ys: Sequence[int], weight: np.ndarray,
                hp: int, wp: int) -> Tuple[np.ndarray, np.ndarray]:
    """The weighted tiles ``(n, t, t, C)`` summed into float64 canvases
    ``(acc, norm)`` of ``(hp, wp, C)`` at the crop origins; the caller
    divides and crops."""
    tiles = np.ascontiguousarray(tiles, dtype=np.float32)
    n, tile, _, c = tiles.shape
    xs, ys = _int32(xs), _int32(ys)
    weight = np.ascontiguousarray(weight, dtype=np.float64)
    acc = np.zeros((hp, wp, c), dtype=np.float64)
    norm = np.zeros((hp, wp, c), dtype=np.float64)
    _library().tileio_merge_f32(tiles.ctypes.data_as(_FP), xs.ctypes.data_as(_IP),
                                ys.ctypes.data_as(_IP), n, tile, c, weight.ctypes.data_as(_DP),
                                hp, wp, acc.ctypes.data_as(_DP), norm.ctypes.data_as(_DP))
    merge_tiles.calls += 1
    return acc, norm


merge_tiles.calls = 0
