"""Fused Activated BatchNorm and training-mode BatchNorm (counterpart of
segtpu/ops/abn.py).

Three kernels, each with a plain PyTorch version beside it here and a CUDA
wrapper in :mod:`segtpu_torch.ops.kernels`. The dispatchers send a CUDA tensor
to the kernel (which launches or raises) and a CPU tensor to the plain
version, which repeats the kernel's fp32 arithmetic:

  B1 :func:`channel_sums`   per-channel fp32 ``(sum a, sum a*b)``
  B2 :func:`abn_norm_act`   ``act(x * scale + shift)`` per channel
  B3 :func:`abn_bwd_sums`   the from-output ABN backward sums ``(edz, eydz)``

Inference folds the running statistics into one per-channel affine,
``scale = gamma * rsqrt(var + eps)`` and ``shift = beta - mean * scale``
(fp32), and applies it with B2. Training runs two ``torch.autograd.Function``s:

  :class:`BNTrain`        BatchNorm with batch statistics (segtpu ``bn_train``):
                          B1 statistics, then the affine through B2 with
                          activation ``"none"``; backward B1 in its pair form
                          on ``(g, x)``, then the ``dx`` expression.
  :class:`FusedABNTrain`  InPlaceABN (segtpu ``_fused_abn_train``): B1
                          statistics, then B2; it saves the output ``z`` and
                          never the input ``x``; backward B3, then ``dx``
                          rebuilt from ``z``.

The ``dx`` passes are plain PyTorch elementwise code in fp32 (segtpu leaves
them to XLA's fusions, outside any Pallas kernel). On the CPU a float64
input stays float64 throughout, so the same code gives a float64 reference
run. Each Function also returns the batch ``(mean, var)``, so a layer
computes its sums once and updates its running statistics from them.
Neither Function uses ``torch.amp.custom_fwd``:
under autocast a convolution hands them bf16, which the kernels read as it
is (fp32 accumulation; outputs keep the input's dtype and memory format,
gamma and beta stay fp32), and nothing inside them is on autocast's cast
lists, so ``custom_fwd``/``custom_bwd`` would change nothing.

Layout: NCHW, channel dim 1, contiguous or channels_last; a 2-D input is a
row-major [M, C] view.

Sync BatchNorm (segtpu's ``axis_name``, segtpu/ops/abn.py:212-220,
:264-266, :310-313, :396-399): given a process group, both Functions
reduce the local shard with the kernels as above and then add the ranks'
partials with one ``all_reduce`` of one packed fp32 buffer per call,
``[sum x | sum x^2 | n]`` in the forward and ``[sum g | sum g*x]`` (B1's
pair) or ``[sum dy | sum xhat*dy]`` (B3) in the backward. The statistics and
the ``dx`` pass use the global sums; the weight and bias gradients stay the
local shard's, which the gradient all-reduce of the data-parallel step
adds.

Grouped statistics (s2d execution, segtpu/ops/abn.py:169-260, :330-470):
with ``parts`` the input's channels are the s2d form of ``sum(parts)`` true
channels, a block-wise concat in which part p spans ``4 * parts[p]``
channels, sub-position-major (:mod:`segtpu_torch.ops.s2d`). B1 and B3 reduce
over all of these channels; the ``[4F]`` fp32 partials are then combined per
true channel (``_combine_parts``, ``_sum_parts``; after the all-reduce under
a process group), the normalisation group of a channel counts ``4 n``
values, and B2 applies the per-channel scale and shift expanded to the s2d
channels (``_expand_parts``). Weight, bias, their gradients and the
statistics that come back keep their dense ``[F]`` shapes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from segtpu_torch.ops import kernels
from segtpu_torch.ops.s2d import blocked_perm
from segtpu_torch.parallel import all_reduce_

ACT_LEAKY_RELU = "leaky_relu"
ACT_ELU = "elu"
ACT_NONE = "none"
_ACTS = (ACT_LEAKY_RELU, ACT_ELU, ACT_NONE)


def _check_act(activation: str) -> None:
    if activation not in _ACTS:
        raise ValueError(f"unknown activation {activation!r}")


def act_forward(y: torch.Tensor, activation: str, slope: float) -> torch.Tensor:
    _check_act(activation)
    if activation == ACT_LEAKY_RELU:
        return torch.where(y >= 0, y, y * slope)
    if activation == ACT_ELU:
        return torch.where(y >= 0, y, torch.expm1(y))
    return y


def act_invert(z: torch.Tensor, activation: str, slope: float) -> torch.Tensor:
    """The pre-activation recovered from the activated output (both
    activations are bijective)."""
    _check_act(activation)
    if activation == ACT_LEAKY_RELU:
        return torch.where(z >= 0, z, z / slope)
    if activation == ACT_ELU:
        return torch.where(z >= 0, z, torch.log1p(z))
    return z


def act_grad_from_output(z: torch.Tensor, activation: str, slope: float) -> torch.Tensor:
    """d activation / d pre-activation, expressed through the output ``z``."""
    _check_act(activation)
    if activation == ACT_LEAKY_RELU:
        return torch.where(z >= 0, 1.0, slope).to(z.dtype)
    if activation == ACT_ELU:
        return torch.where(z >= 0, torch.ones_like(z), z + 1.0)
    return torch.ones_like(z)


def _acc(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic type: fp32, or float64 for a float64
    input (a CPU reference run); the kernels take fp32 and bf16 only."""
    return torch.promote_types(x.dtype, torch.float32)


def _channel_view(x: torch.Tensor) -> Tuple[int, ...]:
    return (1, x.shape[1]) + (1,) * (x.dim() - 2)


def _reduce_dims(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.dim()))


def _on_device(name: str, x: torch.Tensor, cuda_fn, plain_fn, *args):
    if x.device.type == "cuda":
        return cuda_fn(x, *args)
    if x.device.type == "cpu":
        return plain_fn(x, *args)
    raise ValueError(f"{name}: no implementation for device {x.device}")


# ---------------------------------------------------------------------------
# B1: channel sums
# ---------------------------------------------------------------------------

def channel_sums_plain(a: torch.Tensor, b: Optional[torch.Tensor] = None):
    """Per-channel (dim 1) ``(sum a, sum a*b)`` in fp32; ``b=None`` means
    ``b = a``. The B1 kernel's reference; the CPU path of the port."""
    af = a.to(_acc(a))
    bf = af if b is None else b.to(af.dtype)
    dims = _reduce_dims(a)
    return af.sum(dims), (af * bf).sum(dims)


def channel_sums(a: torch.Tensor, b: Optional[torch.Tensor] = None):
    """Dispatch by ``a.device``: the B1 kernel for CUDA tensors, the plain
    version for CPU tensors."""
    return _on_device("channel_sums", a, kernels.channel_sums_cuda, channel_sums_plain, b)


def _global_sums(group, *sums: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``sums`` added over ``group`` in one all-reduce of one packed buffer;
    ``sums`` themselves for no group."""
    if group is None:
        return sums
    buf = torch.cat([s.reshape(-1) for s in sums])
    all_reduce_([buf], group)
    return tuple(buf.split([s.numel() for s in sums]))


def batch_mean_var(x: torch.Tensor, group=None):
    """Per-channel biased batch mean and variance in fp32 over every
    non-channel dim, from one B1 pass (segtpu ``batch_mean_var``); over the
    ranks of ``group`` (sync BatchNorm) when one is given."""
    mean, var, _ = _batch_stats(x, group, None)
    return mean, var


def _batch_stats(x: torch.Tensor, group, parts):
    """Dense batch ``(mean, biased var, count per normalisation group)``
    from one B1 pass; with ``parts`` the s2d sub-channels' moments combined
    per true channel after the all-reduce."""
    s, q = channel_sums(x)
    count = x.numel() // x.shape[1]
    if group is not None:
        s, q, n = _global_sums(group, s, q, s.new_full((1,), count))
        count = n
    if parts is not None:
        mean, var = _combine_parts(s / count, q / count, parts)
        return mean, var, count * 4
    mean = s / count
    return mean, q / count - mean * mean, count


# ---------------------------------------------------------------------------
# Grouped (s2d) statistics
# ---------------------------------------------------------------------------

_perms: Dict[Tuple[Tuple[int, ...], torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}


def _perm(parts: Tuple[int, ...], device: torch.device):
    """``(perm, inverse)`` index tensors on ``device`` between the block-wise
    layout of ``parts`` and the canonical ``(d, c)`` order of the dense
    channels; None for one part, whose layout is the canonical one."""
    if len(parts) == 1:
        return None
    key = (tuple(parts), device)
    if key not in _perms:
        perm = torch.tensor(blocked_perm(tuple(parts)), dtype=torch.long)
        _perms[key] = (perm.to(device), torch.argsort(perm).to(device))
    return _perms[key]


def _canonical(v: torch.Tensor, parts) -> torch.Tensor:
    """A ``[4F]`` vector of the block-wise layout as ``[4, F]``, sub-position
    major."""
    p = _perm(parts, v.device)
    return (v if p is None else v[p[1]]).view(4, -1)


def _sum_parts(v: torch.Tensor, parts) -> torch.Tensor:
    """``[4F] -> [F]``: the sum over each true channel's sub-positions."""
    return _canonical(v, parts).sum(0)


def _combine_parts(sub_mean: torch.Tensor, sub_msq: torch.Tensor, parts):
    """Per-sub-channel mean and mean square ``[4F]`` -> dense ``(mean,
    var)`` ``[F]`` (exact: the sub-positions hold equal counts)."""
    m, q = _canonical(sub_mean, parts), _canonical(sub_msq, parts)
    mean = m.mean(0)
    return mean, q.mean(0) - mean * mean


def _expand_parts(v: torch.Tensor, parts) -> torch.Tensor:
    """Dense ``[F]`` -> the block-wise s2d layout ``[4F]``; ``v`` itself
    without parts."""
    if parts is None:
        return v
    tiled = v.repeat(4)
    p = _perm(parts, v.device)
    return tiled if p is None else tiled[p[0]]


def _sum_to_dense(v: torch.Tensor, parts) -> torch.Tensor:
    return v if parts is None else _sum_parts(v, parts)


# ---------------------------------------------------------------------------
# B2: per-channel affine + activation
# ---------------------------------------------------------------------------

def abn_norm_act_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                       activation: str, slope: float) -> torch.Tensor:
    """act(x * scale + shift) per channel (dim 1) in fp32, rounded once to
    ``x``'s dtype. The B2 kernel's reference; the CPU path of the port."""
    view, acc = _channel_view(x), _acc(x)
    y = x.to(acc) * scale.to(acc).view(view) + shift.to(acc).view(view)
    return act_forward(y, activation, slope).to(x.dtype)


def abn_norm_act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 activation: str, slope: float) -> torch.Tensor:
    """Dispatch by ``x.device``: the B2 kernel for CUDA tensors, the plain
    version for CPU tensors."""
    return _on_device("abn_norm_act", x, kernels.abn_norm_act_cuda, abn_norm_act_plain,
                      scale, shift, activation, slope)


# ---------------------------------------------------------------------------
# B3: from-output ABN backward sums
# ---------------------------------------------------------------------------

def abn_bwd_sums_plain(z: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, activation: str, slope: float):
    """Per-channel (dim 1) fp32 ``(edz, eydz) = (sum dy, sum xhat*dy)`` with
    ``dy = g * act'`` and ``xhat = (act^-1(z) - beta) / gamma``. The B3
    kernel's reference; the CPU path of the port."""
    acc, view = _acc(z), _channel_view(z)
    zf, gf = z.to(acc), g.to(acc)
    dy = gf * act_grad_from_output(zf, activation, slope)
    xhat = (act_invert(zf, activation, slope) - beta.to(acc).view(view)) / gamma.to(acc).view(view)
    dims = _reduce_dims(z)
    return dy.sum(dims), (xhat * dy).sum(dims)


def abn_bwd_sums(z: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 activation: str, slope: float):
    """Dispatch by ``z.device``: the B3 kernel for CUDA tensors, the plain
    version for CPU tensors."""
    return _on_device("abn_bwd_sums", z, kernels.abn_bwd_sums_cuda, abn_bwd_sums_plain,
                      g, gamma, beta, activation, slope)


# ---------------------------------------------------------------------------
# Training-mode autograd Functions
# ---------------------------------------------------------------------------

def _dense(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when it is contiguous or channels_last, else a dense
    copy, counted in ``_dense.copies``: channels_last where the channels
    are x's innermost dim (a packed dense block's prefix), so the layers
    after keep the layout; else contiguous."""
    if x.is_contiguous() or (x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)):
        return x
    _dense.copies += 1
    if x.dim() == 4 and x.stride(1) == 1:
        return x.contiguous(memory_format=torch.channels_last)
    return x.contiguous()


_dense.copies = 0


def _like(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``g`` in ``x``'s dtype and memory layout, the form B1/B3 take a pair in."""
    if x.is_contiguous():
        fmt = torch.contiguous_format
    else:
        fmt = torch.channels_last
    return g.to(dtype=x.dtype).contiguous(memory_format=fmt)


class BNTrain(torch.autograd.Function):
    """Training-mode BatchNorm: ``y = (x - mean) * gamma * rstd + beta`` with
    the batch's biased statistics, differentiable in ``(x, weight, bias)``
    with the full torch training backward (gradients flow through the batch
    statistics). Returns ``(y, mean, var)``; ``mean``/``var`` carry no
    gradient. Forward: B1, then B2 with ``scale = gamma * rstd`` and
    ``shift = beta - mean * scale``. Backward (segtpu abn.py:250-289):
    ``(sum g, sum g*x)`` from B1's pair form, then
    ``dx = w*g - w*d_beta/N - w*rstd*(x - mean)*d_gamma/N`` elementwise.
    ``parts``: grouped s2d statistics (module docstring); the pair sums are
    summed per true channel and N counts the group."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group=None, parts=None):
        x = _dense(x)
        mean, var, _ = _batch_stats(x, group, parts)
        rstd = torch.rsqrt(var + eps)
        scale = weight.to(rstd.dtype) * rstd
        shift = bias.to(rstd.dtype) - mean * scale
        y = abn_norm_act(x, _expand_parts(scale, parts), _expand_parts(shift, parts),
                         ACT_NONE, 0.0)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.group, ctx.parts = group, parts
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, weight, mean, rstd = ctx.saved_tensors
        parts = ctx.parts
        count = x.numel() // x.shape[1]
        g = _like(g, x)
        sub_bias, sub_sgx = channel_sums(g, x)
        d_bias, sgx = _sum_to_dense(sub_bias, parts), _sum_to_dense(sub_sgx, parts)
        d_weight = (sgx - mean * d_bias) * rstd
        w = weight.to(rstd.dtype) * rstd
        all_bias, all_weight = d_bias, d_weight
        if ctx.group is not None:
            all_bias, all_sgx, n = _global_sums(ctx.group, sub_bias, sub_sgx,
                                                sub_bias.new_full((1,), count))
            all_bias, all_sgx = _sum_to_dense(all_bias, parts), _sum_to_dense(all_sgx, parts)
            all_weight, count = (all_sgx - mean * all_bias) * rstd, n
        if parts is not None:
            count = count * 4
        a = _expand_parts(w * all_bias / count, parts)
        b2 = _expand_parts(w * rstd * all_weight / count, parts)
        view, acc = _channel_view(x), rstd.dtype
        dx = (g.to(acc) * _expand_parts(w, parts).view(view)
              - (x.to(acc) - _expand_parts(mean, parts).view(view)) * b2.view(view)
              - a.view(view))
        return (dx.to(x.dtype), d_weight.to(weight.dtype), d_bias.to(weight.dtype), None, None,
                None)


class FusedABNTrain(torch.autograd.Function):
    """Training-mode fused BN + activation with the memory-saving from-output
    backward (segtpu ``_fused_abn_train``; reference inplace_abn). Returns
    ``(z, mean, var)``; ``mean``/``var`` carry no gradient. Saves
    ``(z, gamma, beta, var)`` and never ``x``. Backward: B3 gives
    ``edz = sum dy`` and ``eydz = sum xhat*dy``; then
    ``dx = (dy - edz/N - xhat*eydz/N) * gamma * rstd`` with ``dy`` and
    ``xhat`` rebuilt from ``z``; ``d_gamma = eydz``, ``d_beta = edz``.
    ``parts``: grouped s2d statistics; B3 takes gamma and beta expanded to
    the s2d channels, and its sums are summed per true channel over the
    group's 4N values."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, activation: str, slope: float, group=None,
                parts=None):
        x = _dense(x)
        mean, var, _ = _batch_stats(x, group, parts)
        scale = gamma.to(var.dtype) * torch.rsqrt(var + eps)
        shift = beta.to(var.dtype) - mean * scale
        z = abn_norm_act(x, _expand_parts(scale, parts), _expand_parts(shift, parts),
                         activation, slope)
        ctx.save_for_backward(z, gamma, beta, var)
        ctx.eps, ctx.activation, ctx.slope, ctx.group = eps, activation, slope, group
        ctx.parts = parts
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        z, gamma, beta, var = ctx.saved_tensors
        act, slope, parts = ctx.activation, ctx.slope, ctx.parts
        count = z.numel() // z.shape[1]
        g = _like(g, z)
        acc, view = var.dtype, _channel_view(z)
        gamma_a = _expand_parts(gamma.to(acc), parts).contiguous()
        beta_a = _expand_parts(beta.to(acc), parts).contiguous()
        edz, eydz = abn_bwd_sums(z, g, gamma_a, beta_a, act, slope)
        all_edz, all_eydz = edz, eydz
        if ctx.group is not None:
            all_edz, all_eydz, count = _global_sums(ctx.group, edz, eydz,
                                                    edz.new_full((1,), count))
        if parts is None:
            edz_mean, eydz_mean = all_edz / count, all_eydz / count
        else:
            edz_mean = _expand_parts(_sum_parts(all_edz, parts) / (count * 4), parts)
            eydz_mean = _expand_parts(_sum_parts(all_eydz, parts) / (count * 4), parts)
        zf = z.to(acc)
        dy = g.to(acc) * act_grad_from_output(zf, act, slope)
        xhat = (act_invert(zf, act, slope) - beta_a.view(view)) / gamma_a.view(view)
        w = _expand_parts(gamma.to(acc) * torch.rsqrt(var + ctx.eps), parts)
        dx = (dy - edz_mean.view(view) - xhat * eydz_mean.view(view)) * w.view(view)
        return (dx.to(z.dtype), _sum_to_dense(eydz, parts).to(gamma.dtype),
                _sum_to_dense(edz, parts).to(beta.dtype), None, None, None, None, None)


def bn_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
             group=None, parts: Optional[Tuple[int, ...]] = None):
    """Training-mode BatchNorm: ``(y, batch mean, batch biased var)``; the
    batch is the global one of ``group``'s ranks when a group is given;
    ``parts``: grouped s2d statistics (module docstring)."""
    return BNTrain.apply(x, weight, bias, eps, group, _parts(parts))


def _parts(parts) -> Optional[Tuple[int, ...]]:
    return None if parts is None else tuple(int(p) for p in parts)


def fused_abn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
              mean: Optional[torch.Tensor] = None, var: Optional[torch.Tensor] = None,
              training: bool = False, eps: float = 1e-5, activation: str = ACT_LEAKY_RELU,
              slope: float = 0.01, group=None, parts: Optional[Tuple[int, ...]] = None):
    """Fused BN + activation (segtpu ``fused_abn``).

    ``training=True``: batch statistics (over ``group``'s ranks when one is
    given) and the from-output backward; returns ``(z, mean, var)`` so the
    caller can update its running statistics.
    ``training=False``: the running ``mean``/``var``; returns ``z``.
    ``parts``: grouped s2d statistics (module docstring); gamma, beta and the
    running statistics keep their dense shapes."""
    parts = _parts(parts)
    if training:
        return FusedABNTrain.apply(x, gamma, beta, eps, activation, slope, group, parts)
    if mean is None or var is None:
        raise ValueError("fused_abn(training=False) needs the running mean and var")
    acc = _acc(x)
    scale = gamma.to(acc) * torch.rsqrt(var.to(acc) + eps)
    shift = beta.to(acc) - mean.to(acc) * scale
    return abn_norm_act(x, _expand_parts(scale, parts), _expand_parts(shift, parts), activation,
                        slope)
