"""Build, load and launch the hand-written CUDA kernels of ``segtpu_torch/csrc``.

Each ``*.cu`` source has a plain C launcher and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``. The
build runs at first use, into ``segtpu_torch/csrc/build/`` (ignored by git);
the library's name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded. ``build()`` starts one
``nvcc`` per source, all at once.

Nothing here imports or builds anything at import time: the CPU tests import
every module of the package on a host with no CUDA toolkit.

Each wrapper counts its launches in a plain integer attribute
(``abn_norm_act_cuda.launches``) that is bumped only where the kernel is
launched, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = {"abn_norm_act": "abn_norm_act.cu"}

_ACTIVATIONS = {"none": 0, "leaky_relu": 1, "elu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_libraries: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc): the CUDA kernels of "
                           "segtpu_torch cannot be built on this host")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named kernel (default: all) that is not built yet, one
    ``nvcc`` process per source, all started together. Returns the library
    paths. Raises with the compiler's output when a build fails; on success
    the ``-Xptxas -v`` report (registers, spills) is kept in ``<name>.log``."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def _library(name: str) -> ctypes.CDLL:
    lib = _libraries.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(lib, f"{name}_launch")
        fn.restype = ctypes.c_int
        if name == "abn_norm_act":
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p]
        _libraries[name] = lib
    return lib


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def channel_inner(x: torch.Tensor) -> int:
    """Stride between neighbouring channels (dim 1) of ``x`` in memory order:
    H*W for a contiguous NCHW tensor, 1 for channels_last or a row-major
    [M, C] view. Raises for any other layout."""
    if x.dim() < 2:
        raise ValueError(f"expected a tensor with a channel dim 1, got shape {tuple(x.shape)}")
    if x.is_contiguous():
        inner = 1
        for s in x.shape[2:]:
            inner *= s
        return inner
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return 1
    raise ValueError("abn_norm_act takes a contiguous NCHW, channels_last or "
                     f"[M, C] tensor; got shape {tuple(x.shape)} strides {x.stride()}")


def abn_norm_act_cuda(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                      activation: str, slope: float) -> torch.Tensor:
    """act(x * scale + shift) per channel (dim 1) with the CUDA kernel.

    ``x``: fp32 or bf16 on a CUDA device, contiguous NCHW, channels_last or
    [M, C]. ``scale``/``shift``: fp32 [C] on the same device. The output keeps
    ``x``'s dtype and memory format; the launch is on the current stream and
    does not synchronise."""
    if x.device.type != "cuda":
        raise ValueError(f"abn_norm_act_cuda takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"abn_norm_act_cuda takes float32 or bfloat16, got {x.dtype}")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    c = x.shape[1] if x.dim() >= 2 else -1
    for name, t in (("scale", scale), ("shift", shift)):
        if t.device != x.device or t.dtype != torch.float32 or t.dim() != 1 \
                or t.shape[0] != c or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{c}] tensor on "
                             f"{x.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    inner = channel_inner(x)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    vectorized = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _library("abn_norm_act")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.abn_norm_act_launch(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
            n, inner, c, _DTYPES[x.dtype], _ACTIVATIONS[activation], float(slope),
            vectorized, stream)
    if rc != 0:
        raise RuntimeError(f"abn_norm_act kernel launch failed: cudaError {rc}")
    abn_norm_act_cuda.launches += 1
    return out


abn_norm_act_cuda.launches = 0

# Every CUDA wrapper of the package, by kernel name.
WRAPPERS = {"abn_norm_act": abn_norm_act_cuda}
