"""Build, load and launch the hand-written CUDA kernels of ``segtpu_torch/csrc``.

Each ``*.cu`` source has a plain C launcher and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``. The
build runs at first use, into ``segtpu_torch/csrc/build/`` (ignored by git);
the library's name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and a stale
library is never loaded. ``build()`` starts one ``nvcc`` per source, all at
once.

Nothing here imports or builds anything at import time: the CPU tests import
every module of the package on a host with no CUDA toolkit.

Each wrapper counts its launches in a plain integer attribute
(``abn_norm_act_cuda.launches``) that is bumped only where the kernel is
launched, so a run can show that its main path went through the kernel.

Kernels: B1 ``channel_sums`` (per-channel fp32 (sum a, sum a*b)), B2
``abn_norm_act`` (per-channel affine + activation) and B3 ``abn_bwd``
(from-output ABN backward sums). B1 and B3 are two-pass reductions: the
wrapper allocates their fp32 partials, ``[2, 8 * SMs, C]``, with
``torch.empty``. Their plain PyTorch versions, and the per-device dispatch,
are in :mod:`segtpu_torch.ops.abn`.
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
SOURCES = {"channel_sums": "channel_sums.cu", "abn_norm_act": "abn_norm_act.cu",
           "abn_bwd": "abn_bwd.cu"}
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# argtypes of each ``<name>_launch``: every pointer and the stream c_void_p,
# every size c_longlong.
_ARGTYPES = {
    "channel_sums": [_P] * 5 + [_LL] * 4 + [_I, _I, _P],
    "abn_norm_act": [_P] * 4 + [_LL] * 3 + [_I, _I, _F, _I, _P],
    "abn_bwd": [_P] * 7 + [_LL] * 4 + [_I, _I, _F, _I, _P],
}
_PARTS_PER_SM = 8  # pass-1 partial rows of B1/B3 per SM (channel_reduce.cuh kBlocksPerSM)

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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
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
        fn.argtypes = _ARGTYPES[name]
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
    raise ValueError("the kernels take a contiguous NCHW, channels_last or "
                     f"[M, C] tensor; got shape {tuple(x.shape)} strides {x.stride()}")


def _check_channel_vectors(x: torch.Tensor, **vectors: torch.Tensor) -> None:
    """Each per-channel operand must be a contiguous fp32 [C] tensor on x's device."""
    c = x.shape[1] if x.dim() >= 2 else -1
    for name, t in vectors.items():
        if t.device != x.device or t.dtype != torch.float32 or t.dim() != 1 \
                or t.shape[0] != c or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{c}] tensor on "
                             f"{x.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


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
    _check_channel_vectors(x, scale=scale, shift=shift)
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


def _check_reduce_input(name: str, a: torch.Tensor, b: Optional[torch.Tensor]) -> int:
    """Validate the operands of B1/B3; returns ``channel_inner(a)``."""
    if a.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {a.device}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {a.dtype}")
    inner = channel_inner(a)
    if b is not None:
        if b.device != a.device or b.dtype != a.dtype or b.shape != a.shape:
            raise ValueError(f"{name}: the second operand must match the first in device, "
                             f"dtype and shape; got {b.dtype} {tuple(b.shape)} on {b.device} "
                             f"for {a.dtype} {tuple(a.shape)} on {a.device}")
        if channel_inner(b) != inner:
            raise ValueError(f"{name}: both operands must share one memory layout; strides "
                             f"{a.stride()} and {b.stride()}")
    return inner


def _max_parts(device: torch.device) -> int:
    return _PARTS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def channel_sums_cuda(a: torch.Tensor, b: Optional[torch.Tensor] = None):
    """Per-channel (dim 1) fp32 ``(sum a, sum a*b)`` with the B1 kernel;
    ``b=None`` means ``b = a``.

    ``a`` (and ``b``, of the same dtype, shape and layout): fp32 or bf16 on a
    CUDA device, contiguous NCHW, channels_last or [M, C]. Returns two fp32
    [C] tensors. Launches on the current stream and does not synchronise."""
    inner = _check_reduce_input("channel_sums_cuda", a, b)
    c = a.shape[1]
    s = torch.empty(c, dtype=torch.float32, device=a.device)
    q = torch.empty(c, dtype=torch.float32, device=a.device)
    if a.numel() == 0:
        return s.zero_(), q.zero_()
    parts = _max_parts(a.device)
    scratch = torch.empty((2, parts, c), dtype=torch.float32, device=a.device)
    aligned = int(a.data_ptr() % 16 == 0 and (b is None or b.data_ptr() % 16 == 0))
    lib = _library("channel_sums")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.channel_sums_launch(
            a.data_ptr(), None if b is None else b.data_ptr(), s.data_ptr(), q.data_ptr(),
            scratch.data_ptr(), parts, a.numel(), inner, c, _DTYPES[a.dtype], aligned, stream)
    if rc != 0:
        raise RuntimeError(f"channel_sums kernel launch failed: cudaError {rc}")
    channel_sums_cuda.launches += 1
    return s, q


channel_sums_cuda.launches = 0


def abn_bwd_sums_cuda(z: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, activation: str, slope: float):
    """Per-channel (dim 1) fp32 ``(edz, eydz) = (sum dy, sum xhat*dy)`` of the
    from-output ABN backward with the B3 kernel.

    ``z`` (the layer's output) and ``g`` (its gradient): fp32 or bf16 of one
    dtype, shape and layout on a CUDA device, contiguous NCHW, channels_last
    or [M, C]. ``gamma``/``beta``: fp32 [C] on the same device. Launches on the
    current stream and does not synchronise."""
    inner = _check_reduce_input("abn_bwd_sums_cuda", z, g)
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    c = z.shape[1]
    _check_channel_vectors(z, gamma=gamma, beta=beta)
    edz = torch.empty(c, dtype=torch.float32, device=z.device)
    eydz = torch.empty(c, dtype=torch.float32, device=z.device)
    if z.numel() == 0:
        return edz.zero_(), eydz.zero_()
    parts = _max_parts(z.device)
    scratch = torch.empty((2, parts, c), dtype=torch.float32, device=z.device)
    aligned = int(z.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0)
    lib = _library("abn_bwd")
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = lib.abn_bwd_launch(
            z.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(), edz.data_ptr(),
            eydz.data_ptr(), scratch.data_ptr(), parts, z.numel(), inner, c,
            _DTYPES[z.dtype], _ACTIVATIONS[activation], float(slope), aligned, stream)
    if rc != 0:
        raise RuntimeError(f"abn_bwd kernel launch failed: cudaError {rc}")
    abn_bwd_sums_cuda.launches += 1
    return edz, eydz


abn_bwd_sums_cuda.launches = 0

# Every CUDA wrapper of the package, by kernel name.
WRAPPERS = {"channel_sums": channel_sums_cuda, "abn_norm_act": abn_norm_act_cuda,
            "abn_bwd": abn_bwd_sums_cuda}
