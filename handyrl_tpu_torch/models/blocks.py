"""Shared torch building blocks.

Model convention (as in the JAX package): ``module(obs, hidden)`` returns a
dict with 'policy' (logits) and 'value' (shape (..., 1)); observations
arrive channel-first (..., C, H, W) exactly as environments emit them.
Normalization (``make_norm``) is the JAX package's, written out on NCHW
tensors: GroupNorm with ``min(8, F)`` groups ('group') or one group
('group1', the heads'), flax's eps 1e-6; flax's BatchNorm ('batch':
statistics of the current batch in a training forward, running averages
everywhere else); the batch statistics without running averages
('batchstats'); flax's LayerNorm over the channels of each cell ('layer').
Statistics are fp32. The mode is the explicit ``train`` argument of a
forward, never ``module.training``. The zero-padded blocks
(:class:`ConvBlock`, :class:`PolicyHead`, :class:`ScalarHead`,
:class:`SpatialPolicyHead`) run NCHW; :class:`PolicyHead` and
:class:`ScalarHead` flatten in flax's (H, W, C) order, so a flax ``Dense``
kernel is the transpose of the torch ``Linear`` weight.

A training forward of a 'batch' net reports the running averages it
advanced to the innermost :func:`batch_stats_sink`, so a functional step
(``ops/train_step.py``, :func:`collect_batch_stats`) gets them as new
values of the module's buffers and the buffers themselves never change in
a forward.

The compute dtype (:func:`set_compute_dtype`, the learner's
``compute_dtype``) is flax's ``dtype`` on a module, op by op, not
``torch.autocast``: a conv or dense layer casts its input, its kernel
and its bias to it and returns it (:func:`conv2d`, :func:`linear`,
:func:`dense`); a norm keeps fp32 statistics (and fp32 running averages)
and returns its input's dtype; params stay in their own dtype (fp32).
Where an fp32 tensor meets a bf16 one, torch promotes to fp32 as JAX
does. None, the default, casts nothing: the net runs in its params'
dtype.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6   # flax nn.GroupNorm's epsilon (torch's default is 1e-5)
BN_EPS = 1e-5   # flax nn.BatchNorm's, as the JAX package builds it
LN_EPS = 1e-6   # flax nn.LayerNorm's
# flax weights the old running average by 0.9 (torch's momentum 0.1)
BN_MOMENTUM = 0.9
NORM_KINDS = ('group', 'group1', 'batch', 'batchstats', 'layer')
# the flax module name of each kind's norm layer
NORM_MODULE = {'group': 'GroupNorm_0', 'group1': 'GroupNorm_0',
               'batch': 'BatchNorm_0', 'batchstats': 'BatchStatsNorm_0',
               'layer': 'LayerNorm_0'}

_SINK = threading.local()


@contextlib.contextmanager
def batch_stats_sink():
    """Collects, for the forwards run inside it on this thread, the
    running averages each 'batch' norm advanced: a dict ``(module, buffer
    name) -> new tensor`` (detached), ``(module, buffer name, row)`` for a
    row of a stacked buffer."""
    prev = getattr(_SINK, 'out', None)
    _SINK.out = out = {}
    try:
        yield out
    finally:
        _SINK.out = prev


def compute_dtype_of(module: nn.Module) -> Optional[torch.dtype]:
    """The module's compute dtype; None: its params' own."""
    return getattr(module, 'compute_dtype', None)


def set_compute_dtype(net: nn.Module, dtype) -> nn.Module:
    """Run ``net`` (and each of its submodules) in ``dtype`` (a torch dtype
    or its name; None, '' or float32 for the params' own), as flax's
    ``module.clone(dtype=...)``. The params are left as they are. Returns
    ``net``."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype) if dtype else None
    if dtype == torch.float32:
        dtype = None
    for m in net.modules():
        m.compute_dtype = dtype
    return net


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return t if t is None or dtype is None else t.to(dtype)


# the rows of every conv an acting or serving forward runs on the card:
# the inference engine's largest tick at the default inference.max_batch
ROW_BLOCK = 64


def row_blocks(op: Callable, x: torch.Tensor, *args) -> torch.Tensor:
    """``op(x, *args)`` for a conv, with a row's bits independent of the
    rows beside it. cuDNN picks a conv's algorithm by the batch size: on
    the H100 GeeseNetLSTM's rows in a 16-, 32- or 64-row batch came out up
    to 1.3e-6 off the same rows in an 8-row one (ROADMAP.md §3 F8), where
    the engine's failover and the gateway's journal replay need them
    equal. So a CUDA batch without grad (every acting and serving forward)
    runs as convs of exactly ``ROW_BLOCK`` rows, the last block padded
    with zeros: every row meets the same algorithm whatever its batch. A
    training forward (grad on) and the CPU (whose convs are already row
    invariant) run the batch whole."""
    n = x.shape[0]
    if not x.is_cuda or torch.is_grad_enabled() or n == ROW_BLOCK:
        return op(x, *args)
    pad = -n % ROW_BLOCK
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return torch.cat([op(x[i:i + ROW_BLOCK], *args)
                      for i in range(0, n + pad, ROW_BLOCK)])[:n]


def conv2d(layer: nn.Conv2d, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """flax nn.Conv(dtype=...): the input and the kernel in ``dtype``, the
    bias added in it (flax rounds the conv, then the sum); None runs the
    layer as it is. Row invariant on the card (:func:`row_blocks`)."""
    return row_blocks(_conv2d, x, layer, dtype)


def _conv2d(x: torch.Tensor, layer: nn.Conv2d, dtype) -> torch.Tensor:
    if dtype is None:
        return layer(x)
    y = layer._conv_forward(x.to(dtype), layer.weight.to(dtype), None)
    if layer.bias is not None:
        y = y + layer.bias.to(dtype).reshape(1, -1, 1, 1)
    return y


def linear(layer: nn.Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """flax nn.Dense(dtype=...) on a torch Linear, as :func:`conv2d`."""
    if dtype is None:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def dense(x: torch.Tensor, kernel: torch.Tensor, dtype=None) -> torch.Tensor:
    """flax nn.Dense(use_bias=False, dtype=...) with a flax-layout kernel
    (in, out): ``x @ kernel`` with both in ``dtype``, written as a
    broadcast product summed over ``in`` in fp32 (the products of the
    cast operands are exact there) and rounded once to the operands'
    dtype. A row's bits then do not depend on the rows beside it: cuBLAS
    picks its GEMM by the row count, and on the H100 the Geese policy
    head's rows in a 32- or 64-row batch came out up to 9.5e-7 off the
    same rows in an 8-row one (ROADMAP.md §3 F7), where the per-host
    engine's failover needs them equal."""
    x, kernel = _cast(x, dtype), _cast(kernel, dtype)
    return (x.float().unsqueeze(-1) * kernel.float()).sum(dim=-2).to(x.dtype)


def _moments(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax's ``_compute_stats``: fp32 mean and the fast (biased) variance
    E[x^2] - E[x]^2, clipped at 0, over ``dims`` (kept)."""
    xf = x.float()
    mu = xf.mean(dim=dims, keepdim=True)
    mu2 = (xf * xf).mean(dim=dims, keepdim=True)
    return mu, torch.clamp(mu2 - mu * mu, min=0.0)


def _channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(C,) -> broadcastable against an (N, C, H, W)-like tensor."""
    return v.float().reshape((1, -1) + (1,) * (ndim - 2))


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, train: bool
               ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor,
                                                       torch.Tensor]]]:
    """flax nn.BatchNorm(momentum 0.9, eps 1e-5) on an NCHW tensor. In a
    training forward the current batch's statistics over every axis but
    the channels normalise, and the new running averages ``0.9 * old +
    0.1 * batch`` (the biased variance, as flax) come back beside the
    output; otherwise the running averages normalise and None comes
    back."""
    dims = (0,) + tuple(range(2, x.dim()))
    if train:
        mu, v = _moments(x, dims)
        new = tuple(BN_MOMENTUM * old + (1 - BN_MOMENTUM)
                    * batch.reshape(-1).detach()
                    for old, batch in ((mean, mu), (var, v)))
    else:
        mu, v, new = _channel(mean, x.dim()), _channel(var, x.dim()), None
    mul = torch.rsqrt(v + BN_EPS) * _channel(scale, x.dim())
    y = (x.float() - mu) * mul + _channel(bias, x.dim())
    return y.to(x.dtype), new


def batchstats_norm(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``BatchStatsNorm``: the current batch's fp32
    statistics over every axis but the channels (the two-pass variance,
    as ``jnp.var``), eps 1e-5, in every forward; no running averages. The
    normalised value is rounded to x's dtype and scaled in it, as the JAX
    module does (its scale and bias are params of its dtype)."""
    dims = (0,) + tuple(range(2, x.dim()))
    xf = x.float()
    mu = xf.mean(dim=dims, keepdim=True)
    v = ((xf - mu) ** 2).mean(dim=dims, keepdim=True)
    y = ((xf - mu) / torch.sqrt(v + BN_EPS)).to(x.dtype)
    return (y * _channel(scale, x.dim()).to(x.dtype)
            + _channel(bias, x.dim()).to(x.dtype))


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """flax nn.LayerNorm on an NCHW tensor: each cell normalised over its
    channels alone (flax's last axis of NHWC), eps 1e-6, fp32 fast
    variance."""
    mu, v = _moments(x, (1,))
    y = (x.float() - mu) * (torch.rsqrt(v + LN_EPS)
                            * _channel(scale, x.dim()))
    return (y + _channel(bias, x.dim())).to(x.dtype)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) -> (..., H, W, C)."""
    return torch.movedim(x, -3, -1)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int) -> torch.Tensor:
    """flax nn.GroupNorm on an NCHW tensor: fp32 statistics per sample over
    the board and the channels of each group, then scale and bias."""
    y = F.group_norm(x.float(), groups, scale.float(), bias.float(),
                     eps=GN_EPS)
    return y.to(x.dtype)


def _halo_correct(y: torch.Tensor, x: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Add the wrapped-edge terms a zero-padded 3x3 conv omitted.

    y = conv(x) with padding 1, x (N, C, H, W), w (F, C, 3, 3). Output row 0
    misses kernel row 0 sourced from row H-1 (a 1-row conv with columns
    zero-padded), row H-1 misses kernel row 2 sourced from row 0, the edge
    columns likewise, and each corner one diagonal tap."""
    H, W = x.shape[-2:]
    y = y.clone()
    y[:, :, :1] += F.conv2d(x[:, :, H - 1:], w[:, :, :1], padding=(0, 1))
    y[:, :, H - 1:] += F.conv2d(x[:, :, :1], w[:, :, 2:], padding=(0, 1))
    y[..., :1] += F.conv2d(x[..., W - 1:], w[..., :1], padding=(1, 0))
    y[..., W - 1:] += F.conv2d(x[..., :1], w[..., 2:], padding=(1, 0))
    for (i, j), (si, sj), (ki, kj) in (
            ((0, 0), (H - 1, W - 1), (0, 0)),
            ((0, W - 1), (H - 1, 0), (0, 2)),
            ((H - 1, 0), (0, W - 1), (2, 0)),
            ((H - 1, W - 1), (0, 0), (2, 2))):
        y[:, :, i, j] += x[:, :, si, sj] @ w[:, :, ki, kj].t()
    return y


def torus_conv(x: torch.Tensor, kernel: torch.Tensor,
               impl: str = 'pad') -> torch.Tensor:
    """3x3 conv with wrap-around (toroidal) padding on an NCHW tensor, the
    kernel in flax's HWIO layout (3, 3, C, F).

    ``impl='pad'`` wrap-pads with ``F.pad(mode='circular')`` and runs a
    VALID conv; ``impl='halo'`` runs a zero-padded conv and adds back the
    wrapped contributions (:func:`_halo_correct`). Both are the same
    function. Row invariant on the card (:func:`row_blocks`)."""
    if impl not in ('pad', 'halo'):
        raise ValueError('unknown TorusConv impl %r' % (impl,))
    w = kernel.permute(3, 2, 0, 1).to(x.dtype)        # HWIO -> OIHW
    return row_blocks(_torus_conv, x, w, impl)


def _torus_conv(x: torch.Tensor, w: torch.Tensor, impl: str) -> torch.Tensor:
    if impl == 'pad':
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode='circular'), w)
    return _halo_correct(F.conv2d(x, w, padding=1), x, w)


class TorusConv(nn.Module):
    """Torus conv + norm on NCHW tensors, the counterpart of the JAX
    package's ``blocks.TorusConv``.

    It holds no parameters: the caller passes the conv kernel (HWIO) and
    the norm's scale and bias, so a net can keep its layers stacked in the
    fused kernel's layout and slice them per layer. A 'batch' norm reads
    its running averages from the caller's stacked buffers (``owner``,
    ``stats`` names, row ``index``; :func:`norm_nchw`)."""

    def __init__(self, impl: str = 'pad', groups: int = 8,
                 norm_kind: str = 'group'):
        super().__init__()
        if impl not in ('pad', 'halo'):
            raise ValueError('unknown TorusConv impl %r' % (impl,))
        if norm_kind not in NORM_KINDS:
            raise ValueError('unknown norm kind %r' % (norm_kind,))
        self.impl = impl
        self.groups = groups
        self.norm_kind = norm_kind

    def forward(self, x: torch.Tensor, kernel: torch.Tensor,
                scale: torch.Tensor, bias: torch.Tensor,
                owner: Optional[nn.Module] = None,
                stats: Tuple[str, str] = ('mean', 'var'),
                index: Optional[int] = None,
                train: bool = False) -> torch.Tensor:
        x = _cast(x, compute_dtype_of(self))
        return norm_nchw(self.norm_kind, torus_conv(x, kernel, self.impl),
                         scale, bias, self.groups, owner, train, stats,
                         index)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]):
    """flax's default kernel init: truncated normal in [-2, 2] std units,
    variance 1/fan_in after truncation."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        t.mul_(std)


class _Norm(nn.Module):
    """A norm over ``filters`` channels with flax's scale ('weight') and
    bias; ``forward(x, train=False)`` on NCHW tensors."""

    def __init__(self, kind: str, filters: int):
        super().__init__()
        self.kind = kind
        self.weight = nn.Parameter(torch.ones(filters))
        self.bias = nn.Parameter(torch.zeros(filters))
        self.groups = 1
        if kind == 'group':
            self.groups = min(8, filters)
        elif kind == 'batch':
            # flax's batch_stats collection: running mean 0 and var 1
            self.register_buffer('mean', torch.zeros(filters))
            self.register_buffer('var', torch.ones(filters))
        elif kind not in ('group1', 'batchstats', 'layer'):
            # never fall back silently: a typo'd kind reinstating GroupNorm
            # would run another net than the one asked for
            raise ValueError('unknown norm kind %r' % (kind,))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return norm_nchw(self.kind, x, self.weight, self.bias, self.groups,
                         self, train=train)


def norm_nchw(kind: str, x: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, groups: int = 1,
              owner: Optional[nn.Module] = None, train: bool = False,
              stats: Tuple[str, str] = ('mean', 'var'),
              index: Optional[int] = None) -> torch.Tensor:
    """The norm ``kind`` of :func:`make_norm` on an NCHW tensor with the
    given scale and bias. A 'batch' norm reads its running averages from
    ``owner``'s buffers named ``stats`` (row ``index`` of stacked ones)
    and, in a training forward, reports their new values for that row to
    the active :func:`batch_stats_sink` (stacked buffers collect one row
    a call, under (owner, name, index))."""
    if kind in ('group', 'group1'):
        return group_norm(x, scale, bias, groups)
    if kind == 'batchstats':
        return batchstats_norm(x, scale, bias)
    if kind == 'layer':
        return layer_norm(x, scale, bias)
    if kind != 'batch':
        raise ValueError('unknown norm kind %r' % (kind,))
    mean, var = (getattr(owner, n) for n in stats)
    if index is not None:
        mean, var = mean[index], var[index]
    y, new = batch_norm(x, scale, bias, mean, var, train)
    if new is not None:
        out = getattr(_SINK, 'out', None)
        if out is not None:
            for name, t in zip(stats, new):
                out[(owner, name) if index is None
                    else (owner, name, index)] = t.detach()
    return y


def make_norm(kind: str, filters: int) -> nn.Module:
    """The JAX package's ``make_norm`` on NCHW tensors: 'group'
    (``min(8, filters)`` groups), 'group1' (one group over (C, H, W), the
    heads' flavour), 'batch' (flax's BatchNorm with running averages in
    the buffers ``mean`` and ``var``), 'batchstats' or 'layer'. Every kind
    holds a scale ('weight', ones) and a bias (zeros); an unknown kind
    raises."""
    return _Norm(kind, filters)


def collect_batch_stats(module: nn.Module, sink: Dict) -> Dict[str,
                                                               torch.Tensor]:
    """A :func:`batch_stats_sink`'s entries as new values of ``module``'s
    buffers by their state-dict names (rows of a stacked buffer stacked
    back in order)."""
    names = {m: n for n, m in module.named_modules()}
    rows: Dict[str, Dict[int, torch.Tensor]] = {}
    out: Dict[str, torch.Tensor] = {}
    for key, t in sink.items():
        prefix = names[key[0]]
        name = (prefix + '.' if prefix else '') + key[1]
        if len(key) == 3:
            rows.setdefault(name, {})[key[2]] = t
        else:
            out[name] = t
    for name, by_row in rows.items():
        out[name] = torch.stack([by_row[i] for i in sorted(by_row)])
    return out


def _reset_norm(norm: nn.Module):
    with torch.no_grad():
        norm.weight.fill_(1.0)
        norm.bias.zero_()
        if getattr(norm, 'kind', None) == 'batch':
            norm.mean.zero_()
            norm.var.fill_(1.0)


def init_kernel_(weight: torch.Tensor, fan_in: int, init_kind: str,
                 generator: Optional[torch.Generator],
                 bias: Optional[torch.Tensor] = None):
    """A conv or dense layer's init under the JAX package's ``init_kind``
    (``conv_inits`` / ``dense_inits``): 'flax', lecun_normal kernel and
    zero bias; 'torch', ``torch_default_inits``: kernel and bias uniform
    in +-1/sqrt(fan_in) (fan_in = receptive field x input channels)."""
    if init_kind == 'flax':
        lecun_normal_(weight, fan_in, generator)
        if bias is not None:
            with torch.no_grad():
                bias.zero_()
    elif init_kind == 'torch':
        bound = 1.0 / fan_in ** 0.5
        with torch.no_grad():
            for t in (weight, bias):
                if t is not None:
                    t.uniform_(-bound, bound, generator=generator)
    else:
        raise ValueError('unknown init_kind %r' % (init_kind,))


def _reset_conv(conv: nn.Conv2d, generator: Optional[torch.Generator],
                init_kind: str = 'flax'):
    """flax's nn.Conv init under ``init_kind`` (lecun_normal kernel, zero
    bias by default)."""
    o, i, kh, kw = conv.weight.shape
    init_kernel_(conv.weight, i * kh * kw, init_kind, generator, conv.bias)


def _reset_dense(dense: nn.Linear, generator: Optional[torch.Generator],
                 init_kind: str = 'flax'):
    init_kernel_(dense.weight, dense.in_features, init_kind, generator,
                 dense.bias)


def _flatten_hwc(h: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H*W*C), flax's flatten order of NHWC."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


class ConvBlock(nn.Module):
    """Zero-padded ('SAME') 3x3 conv without a bias + norm on NCHW
    (``handyrl_tpu/models/blocks.py`` ConvBlock as every JAX net uses
    it), in the compute dtype."""

    def __init__(self, in_channels: int, filters: int,
                 norm_kind: str = 'group', init_kind: str = 'flax'):
        super().__init__()
        self.init_kind = init_kind
        self.conv = nn.Conv2d(in_channels, filters, 3, padding=1, bias=False)
        self.norm = make_norm(norm_kind, filters)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_conv(self.conv, generator, self.init_kind)
        _reset_norm(self.norm)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.norm(conv2d(self.conv, x, compute_dtype_of(self)), train)


class PolicyHead(nn.Module):
    """1x1 conv (with bias) -> leaky-relu(0.1) -> dense logits without a
    bias, over a board of ``cells`` cells."""

    def __init__(self, in_channels: int, out_filters: int, outputs: int,
                 cells: int, init_kind: str = 'flax'):
        super().__init__()
        self.init_kind = init_kind
        self.conv = nn.Conv2d(in_channels, out_filters, 1)
        self.dense = nn.Linear(out_filters * cells, outputs, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_conv(self.conv, generator, self.init_kind)
        _reset_dense(self.dense, generator, self.init_kind)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype_of(self)
        h = F.leaky_relu(conv2d(self.conv, x, dt), negative_slope=0.1)
        return linear(self.dense, _flatten_hwc(h), dt)


class ScalarHead(nn.Module):
    """1x1 conv (no bias) + norm (one-group GroupNorm by default) + relu ->
    dense scalar(s) without a bias, over a board of ``cells`` cells."""

    def __init__(self, in_channels: int, filters: int, outputs: int,
                 cells: int, norm_kind: str = 'group1',
                 init_kind: str = 'flax'):
        super().__init__()
        self.init_kind = init_kind
        self.conv = nn.Conv2d(in_channels, filters, 1, bias=False)
        self.norm = make_norm(norm_kind, filters)
        self.dense = nn.Linear(filters * cells, outputs, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_conv(self.conv, generator, self.init_kind)
        _reset_norm(self.norm)
        _reset_dense(self.dense, generator, self.init_kind)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = compute_dtype_of(self)
        h = torch.relu(self.norm(conv2d(self.conv, x, dt), train))
        return linear(self.dense, _flatten_hwc(h), dt)


class SpatialPolicyHead(nn.Module):
    """Per-cell policy logits, the JAX package's ``SpatialPolicyHead``: a
    zero-padded 3x3 conv (no bias) + norm + relu, then a 1x1 conv (with a
    bias) to ``out_filters`` logits per cell, flattened channel-major
    (logit = f * H * W + x * W + y, the '4 x 36' move encoding)."""

    def __init__(self, in_channels: int, filters: int, out_filters: int,
                 norm_kind: str = 'group1', init_kind: str = 'flax'):
        super().__init__()
        self.init_kind = init_kind
        self.conv = nn.Conv2d(in_channels, filters, 3, padding=1, bias=False)
        self.norm = make_norm(norm_kind, filters)
        self.out = nn.Conv2d(filters, out_filters, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_conv(self.conv, generator, self.init_kind)
        _reset_norm(self.norm)
        _reset_conv(self.out, generator, self.init_kind)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = compute_dtype_of(self)
        h = torch.relu(self.norm(conv2d(self.conv, x, dt), train))
        # NCHW: channel-major
        return conv2d(self.out, h, dt).reshape(x.shape[0], -1)


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM cell on NCHW feature maps, the port of the JAX
    package's ``blocks.ConvLSTMCell``.

    The gates come from one zero-padded ('SAME') ``kernel`` x ``kernel``
    conv (with a bias) over the channel concatenation ``[x, h_prev]``,
    split in the order i, f, o, g; then ``c = sigmoid(f) * c_prev +
    sigmoid(i) * tanh(g)`` and ``h = sigmoid(o) * tanh(c)``. The state is
    an ``(h, c)`` tuple of (N, F, H, W) tensors. The flax kernel (k, k,
    C + F, 4F) is HWIO over the same concatenation, so it maps to the
    torch weight by the permutation alone."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 init_kind: str = 'flax'):
        super().__init__()
        self.features = int(features)
        self.init_kind = init_kind
        self.conv = nn.Conv2d(in_channels + features, 4 * features, kernel,
                              padding=kernel // 2)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_conv(self.conv, generator, self.init_kind)

    def forward(self, x: torch.Tensor, state):
        h_prev, c_prev = state
        gates = conv2d(self.conv, torch.cat([x, h_prev.to(x.dtype)], dim=1),
                       compute_dtype_of(self))
        i, f, o, g = torch.chunk(gates, 4, dim=1)
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


class DRC(nn.Module):
    """Deep Repeated ConvLSTM (Guez et al. 2019) on NCHW feature maps, the
    port of the JAX package's ``blocks.DRC``: ``num_layers`` stacked
    :class:`ConvLSTMCell`s applied ``num_repeats`` times an observation;
    layer i > 0 reads layer i - 1's fresh hidden state. The state is
    ``(hs, cs)``, lists of (N, F, H, W) tensors, one a layer."""

    def __init__(self, in_channels: int, num_layers: int = 3,
                 features: int = 32, kernel: int = 3, num_repeats: int = 3,
                 init_kind: str = 'flax'):
        super().__init__()
        self.num_layers, self.features = int(num_layers), int(features)
        self.num_repeats = int(num_repeats)
        self.cells = nn.ModuleList(
            ConvLSTMCell(in_channels if i == 0 else features, features,
                         kernel, init_kind) for i in range(self.num_layers))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for cell in self.cells:
            cell.reset_parameters(generator)

    def initial_state(self, x: torch.Tensor):
        """Zeros for every layer, shaped as ``x``'s board with F channels,
        in the compute dtype (else x's)."""
        shape = (x.shape[0], self.features) + tuple(x.shape[-2:])
        kw = dict(dtype=compute_dtype_of(self) or x.dtype)
        return ([x.new_zeros(shape, **kw) for _ in range(self.num_layers)],
                [x.new_zeros(shape, **kw) for _ in range(self.num_layers)])

    def forward(self, x: torch.Tensor, state=None):
        if state is None:
            state = self.initial_state(x)
        hs, cs = list(state[0]), list(state[1])
        for _ in range(self.num_repeats):
            for i, cell in enumerate(self.cells):
                inp = x if i == 0 else hs[i - 1]
                _, (hs[i], cs[i]) = cell(inp, (hs[i], cs[i]))
        return hs[-1], (hs, cs)
