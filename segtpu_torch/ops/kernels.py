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
(from-output ABN backward sums). B1 and B3 share the one-launch reduction of
``csrc/channel_reduce.cuh``. Its launch plan is computed here
(:func:`reduce_plan`, cached per shape, dtype, layout, alignment and SM
count) and checked by the launcher; the SM count is read once per device,
and the int32 counters of the reduction's second level are allocated zeroed
once per (device, stream) and left at zero by every launch. The scratch of
that level, ``[2, clusters, C]`` sums (fp64 for fp32 inputs, fp32 for bf16),
is sized from the plan and allocated only when a channel tile spans more
than one cluster. The plain PyTorch
versions, and the per-device dispatch, are in :mod:`segtpu_torch.ops.abn`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

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
    "channel_sums": [_P] * 7 + [_I, _P],
    "abn_norm_act": [_P] * 4 + [_LL] * 3 + [_I, _I, _F, _I, _P],
    "abn_bwd": [_P] * 9 + [_I, _I, _F, _P],
}

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


# ---------------------------------------------------------------------------
# B1 and B3: the launch plan of csrc/channel_reduce.cuh
# ---------------------------------------------------------------------------

REDUCE_THREADS = 256      # threads per block (kThreads)
REDUCE_MAX_WIDTH = 256    # channels per tile that the shared arrays hold (kMaxWidth)
REDUCE_MAX_CLUSTER = 8    # the portable cluster size (kMaxCluster)
REDUCE_MAX_LANES = 32     # threads per channel in the second level (kMaxLanes)
REDUCE_BLOCKS_PER_SM = 2  # grid target, chosen by measurement (PERF.md §6)
MAX_GRID = 2**31 - 1      # blocks of a one-dimensional grid


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """How one B1/B3 call is cut into blocks; the fields, in order, are those
    of the C struct ``chred::Plan``.

    ``rows_layout``: rows of C channels (inner == 1), else NCHW planes. A
    tile of ``width`` channels (one channel for planes; ``tx`` threads
    across it, ``vec`` elements per load) is covered by ``cluster *
    clusters`` blocks, block k taking rows (or the channel's vectors)
    ``[k * span, (k + 1) * span)`` of its ``extent``; a block's threads take
    ``step`` of them per loop trip, ``unroll`` loads in flight per input.
    ``acc_bytes``: the type the sums are carried in, fp64 (8) for fp32
    inputs and fp32 (4) for bf16."""

    rows_layout: bool
    vec: int
    tx: int
    width: int
    tiles: int
    extent: int
    step: int
    unroll: int
    span: int
    cluster: int
    clusters: int
    channels: int
    inner: int
    acc_bytes: int

    @property
    def blocks_per_tile(self) -> int:
        return self.cluster * self.clusters

    @property
    def grid(self) -> int:
        return self.tiles * self.blocks_per_tile

    @property
    def scratch_bytes(self) -> int:
        """Bytes of the second level's scratch, ``[2, clusters, C]`` sums; 0
        with one cluster per tile."""
        return 2 * self.clusters * self.channels * self.acc_bytes if self.clusters > 1 else 0

    @property
    def counters(self) -> int:
        """int32 counters the second level needs (one per tile); 0 with one
        cluster per tile."""
        return self.tiles if self.clusters > 1 else 0

    @functools.cached_property
    def packed(self):
        """The fields as the int64 array that the C launchers read."""
        values = [int(getattr(self, f.name)) for f in dataclasses.fields(self)]
        return (ctypes.c_longlong * len(values))(*values)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def reduce_plan(shape: Tuple[int, ...], dtype: torch.dtype, inner: int, aligned: bool,
                sms: int, pair: bool) -> ReducePlan:
    """The launch plan of one B1/B3 call.

    ``shape``: the input's shape, channel dim 1; ``inner``: the stride
    between neighbouring channels (:func:`channel_inner`: 1 for
    channels_last or [M, C], H*W for contiguous NCHW); ``aligned``: every
    operand starts on a 16-byte boundary; ``sms``: the card's SM count;
    ``pair``: two inputs. Each thread keeps 4 loads in flight for one input
    and 2 per input for two (64 bytes a thread either way with 16-byte
    loads).

    The grid aims at REDUCE_BLOCKS_PER_SM blocks per SM, at least one loop
    trip each, in clusters of up to REDUCE_MAX_CLUSTER blocks per tile; the
    rows or vectors are shared out evenly in whole trips, and only the last
    cluster of a tile may hold empty blocks. The plan depends on its
    arguments alone, so the kernel adds in the same order, to the same bits,
    on every call."""
    shape = tuple(int(s) for s in shape)
    if dtype not in _DTYPES:
        raise TypeError(f"the reduction takes float32 or bfloat16, got {dtype}")
    if len(shape) < 2 or shape[1] <= 0 or inner <= 0:
        raise ValueError(f"no reduction plan for shape {shape} with inner {inner}")
    channels, numel = shape[1], 1
    for d in shape:
        numel *= d
    if numel <= 0 or numel % (channels * inner) != 0:
        raise ValueError(f"no reduction plan for shape {shape} with inner {inner}")
    unroll = 2 if pair else 4
    full_vec = 16 // dtype.itemsize
    if inner == 1:
        vec = full_vec if aligned and channels % full_vec == 0 else 1
        tx = 1
        while tx < 32 and tx < channels // vec:
            tx *= 2
        width, tiles = tx * vec, _cdiv(channels // vec, tx)
        extent = numel // channels
        step = (REDUCE_THREADS // tx) * unroll
    else:
        vec = full_vec if aligned and inner % full_vec == 0 else 1
        tx, width, tiles = 1, 1, channels
        extent = numel // channels // vec
        step = REDUCE_THREADS * unroll
        if extent + step >= 2**31:  # the planes kernel indexes a channel in 32 bits
            raise ValueError(f"shape {shape}: a channel of {extent} vectors is too long "
                             "for the NCHW kernel; use channels_last")
    blocks = max(1, min(_cdiv(REDUCE_BLOCKS_PER_SM * sms, tiles), _cdiv(extent, step)))
    cluster = min(REDUCE_MAX_CLUSTER, blocks)
    span = _cdiv(_cdiv(extent, cluster * _cdiv(blocks, cluster)), step) * step
    clusters = _cdiv(_cdiv(extent, span), cluster)
    plan = ReducePlan(inner == 1, vec, tx, width, tiles, extent, step, unroll, span, cluster,
                      clusters, channels, inner, 8 if dtype == torch.float32 else 4)
    if plan.grid > MAX_GRID:
        raise ValueError(f"shape {shape} needs {plan.grid} blocks, more than a grid holds")
    return plan


_sm_counts: Dict[int, int] = {}
_counter_buffers: Dict[Tuple[int, int], torch.Tensor] = {}


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, read once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for the reductions launched on
    ``stream``: allocated once per (device, stream), and anew, larger, when
    a plan needs more. Every launch leaves them at zero."""
    key = (device.index, stream)
    buf = _counter_buffers.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counter_buffers[key] = buf
    return buf


def counter_buffers() -> List[torch.Tensor]:
    """Every cached counter buffer; between launches they hold zeros."""
    return list(_counter_buffers.values())


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _reduce_launch(name: str, plan: ReducePlan, a: torch.Tensor, b: torch.Tensor, *extra):
    """Launch B1 (``name="channel_sums"``; ``b`` may be None) or B3
    (``"abn_bwd"``; ``extra`` = gamma, beta, activation, slope) on ``plan``
    and return the two fp32 [C] sums. The caller, one of the two wrappers,
    has checked the operands, made ``plan`` for them, and counts the
    launch."""
    c = plan.channels
    u = torch.empty(c, dtype=torch.float32, device=a.device)
    v = torch.empty(c, dtype=torch.float32, device=a.device)
    part = (torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=a.device)
            if plan.clusters > 1 else None)
    lib = _library(name)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        counters = _counters(a.device, stream, plan.counters) if plan.clusters > 1 else None
        if name == "channel_sums":
            rc = lib.channel_sums_launch(a.data_ptr(), _ptr(b), u.data_ptr(), v.data_ptr(),
                                         _ptr(part), _ptr(counters), plan.packed,
                                         _DTYPES[a.dtype], stream)
        else:
            gamma, beta, activation, slope = extra
            rc = lib.abn_bwd_launch(a.data_ptr(), b.data_ptr(), gamma.data_ptr(),
                                    beta.data_ptr(), u.data_ptr(), v.data_ptr(), _ptr(part),
                                    _ptr(counters), plan.packed, _DTYPES[a.dtype],
                                    _ACTIVATIONS[activation], float(slope), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return u, v


def _plan_for(a: torch.Tensor, b: Optional[torch.Tensor], inner: int) -> ReducePlan:
    aligned = a.data_ptr() % 16 == 0 and (b is None or b.data_ptr() % 16 == 0)
    return reduce_plan(a.shape, a.dtype, inner, aligned, sm_count(a.device), b is not None)


def channel_sums_cuda(a: torch.Tensor, b: Optional[torch.Tensor] = None):
    """Per-channel (dim 1) fp32 ``(sum a, sum a*b)`` with the B1 kernel;
    ``b=None`` means ``b = a``.

    ``a`` (and ``b``, of the same dtype, shape and layout): fp32 or bf16 on a
    CUDA device, contiguous NCHW, channels_last or [M, C]. Returns two fp32
    [C] tensors. One kernel launch on the current stream, no
    synchronisation."""
    inner = _check_reduce_input("channel_sums_cuda", a, b)
    c = a.shape[1]
    if a.numel() == 0:
        return (torch.zeros(c, dtype=torch.float32, device=a.device),
                torch.zeros(c, dtype=torch.float32, device=a.device))
    s, q = _reduce_launch("channel_sums", _plan_for(a, b, inner), a, b)
    channel_sums_cuda.launches += 1
    return s, q


channel_sums_cuda.launches = 0


def abn_bwd_sums_cuda(z: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, activation: str, slope: float):
    """Per-channel (dim 1) fp32 ``(edz, eydz) = (sum dy, sum xhat*dy)`` of the
    from-output ABN backward with the B3 kernel.

    ``z`` (the layer's output) and ``g`` (its gradient): fp32 or bf16 of one
    dtype, shape and layout on a CUDA device, contiguous NCHW, channels_last
    or [M, C]. ``gamma``/``beta``: fp32 [C] on the same device. One kernel
    launch on the current stream, no synchronisation."""
    inner = _check_reduce_input("abn_bwd_sums_cuda", z, g)
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    c = z.shape[1]
    _check_channel_vectors(z, gamma=gamma, beta=beta)
    if z.numel() == 0:
        return (torch.zeros(c, dtype=torch.float32, device=z.device),
                torch.zeros(c, dtype=torch.float32, device=z.device))
    edz, eydz = _reduce_launch("abn_bwd", _plan_for(z, g, inner), z, g, gamma, beta,
                               activation, slope)
    abn_bwd_sums_cuda.launches += 1
    return edz, eydz


abn_bwd_sums_cuda.launches = 0

# Every CUDA wrapper of the package, by kernel name.
WRAPPERS = {"channel_sums": channel_sums_cuda, "abn_norm_act": abn_norm_act_cuda,
            "abn_bwd": abn_bwd_sums_cuda}
