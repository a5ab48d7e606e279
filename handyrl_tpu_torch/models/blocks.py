"""Shared torch building blocks.

Model convention (as in the JAX package): ``module(obs, hidden)`` returns a
dict with 'policy' (logits) and 'value' (shape (..., 1)); observations
arrive channel-first (..., C, H, W) exactly as environments emit them.
Normalization is GroupNorm with ``min(8, F)`` groups ('group') or one group
('group1', the heads'), flax's eps 1e-6, statistics in fp32. The zero-padded
blocks (:class:`ConvBlock`, :class:`PolicyHead`, :class:`ScalarHead`) run
NCHW and flatten their heads in flax's (H, W, C) order, so a flax ``Dense``
kernel is the transpose of the torch ``Linear`` weight.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6   # flax nn.GroupNorm's epsilon (torch's default is 1e-5)


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
    function."""
    w = kernel.permute(3, 2, 0, 1).to(x.dtype)        # HWIO -> OIHW
    if impl == 'pad':
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode='circular'), w)
    if impl == 'halo':
        return _halo_correct(F.conv2d(x, w, padding=1), x, w)
    raise ValueError('unknown TorusConv impl %r' % (impl,))


class TorusConv(nn.Module):
    """Torus conv + GroupNorm on NCHW tensors, the counterpart of the JAX
    package's ``blocks.TorusConv`` (norm_kind='group').

    It holds no parameters: the caller passes the conv kernel (HWIO) and
    the GroupNorm scale and bias, so a net can keep its layers stacked in
    the fused kernel's layout and slice them per layer."""

    def __init__(self, impl: str = 'pad', groups: int = 8):
        super().__init__()
        if impl not in ('pad', 'halo'):
            raise ValueError('unknown TorusConv impl %r' % (impl,))
        self.impl = impl
        self.groups = groups

    def forward(self, x: torch.Tensor, kernel: torch.Tensor,
                scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return group_norm(torus_conv(x, kernel, self.impl), scale, bias,
                          self.groups)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]):
    """flax's default kernel init: truncated normal in [-2, 2] std units,
    variance 1/fan_in after truncation."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        t.mul_(std)


def make_norm(kind: str, filters: int) -> nn.GroupNorm:
    """The JAX package's ``make_norm`` for 'group' (``min(8, filters)``
    groups) and 'group1' (one group over (H, W, C), the heads' flavour);
    its other kinds are not ported and raise."""
    if kind == 'group':
        return nn.GroupNorm(min(8, filters), filters, eps=GN_EPS)
    if kind == 'group1':
        return nn.GroupNorm(1, filters, eps=GN_EPS)
    raise ValueError('norm kind %r is not ported (the port has group and '
                     'group1)' % (kind,))


def _reset_norm(norm: nn.GroupNorm):
    with torch.no_grad():
        norm.weight.fill_(1.0)
        norm.bias.zero_()


def _reset_conv(conv: nn.Conv2d, generator: Optional[torch.Generator]):
    """flax's nn.Conv defaults: lecun_normal kernel, zero bias."""
    o, i, kh, kw = conv.weight.shape
    lecun_normal_(conv.weight, i * kh * kw, generator)
    if conv.bias is not None:
        with torch.no_grad():
            conv.bias.zero_()


def _flatten_hwc(h: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H*W*C), flax's flatten order of NHWC."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


class ConvBlock(nn.Module):
    """Zero-padded ('SAME') 3x3 conv without a bias + GroupNorm on NCHW
    (``handyrl_tpu/models/blocks.py`` ConvBlock as every JAX net uses
    it)."""

    def __init__(self, in_channels: int, filters: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, filters, 3, padding=1, bias=False)
        self.norm = make_norm('group', filters)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_conv(self.conv, generator)
        _reset_norm(self.norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class PolicyHead(nn.Module):
    """1x1 conv (with bias) -> leaky-relu(0.1) -> dense logits without a
    bias, over a board of ``cells`` cells."""

    def __init__(self, in_channels: int, out_filters: int, outputs: int,
                 cells: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_filters, 1)
        self.dense = nn.Linear(out_filters * cells, outputs, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_conv(self.conv, generator)
        lecun_normal_(self.dense.weight, self.dense.in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv(x), negative_slope=0.1)
        return self.dense(_flatten_hwc(h))


class ScalarHead(nn.Module):
    """1x1 conv (no bias) + one-group GroupNorm + relu -> dense scalar(s)
    without a bias, over a board of ``cells`` cells."""

    def __init__(self, in_channels: int, filters: int, outputs: int,
                 cells: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, filters, 1, bias=False)
        self.norm = make_norm('group1', filters)
        self.dense = nn.Linear(filters * cells, outputs, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_conv(self.conv, generator)
        _reset_norm(self.norm)
        lecun_normal_(self.dense.weight, self.dense.in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.norm(self.conv(x)))
        return self.dense(_flatten_hwc(h))


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

    def __init__(self, in_channels: int, features: int, kernel: int = 3):
        super().__init__()
        self.features = int(features)
        self.conv = nn.Conv2d(in_channels + features, 4 * features, kernel,
                              padding=kernel // 2)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_conv(self.conv, generator)

    def forward(self, x: torch.Tensor, state):
        h_prev, c_prev = state
        gates = self.conv(torch.cat([x, h_prev.to(x.dtype)], dim=1))
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
                 features: int = 32, kernel: int = 3, num_repeats: int = 3):
        super().__init__()
        self.num_layers, self.features = int(num_layers), int(features)
        self.num_repeats = int(num_repeats)
        self.cells = nn.ModuleList(
            ConvLSTMCell(in_channels if i == 0 else features, features,
                         kernel) for i in range(self.num_layers))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for cell in self.cells:
            cell.reset_parameters(generator)

    def initial_state(self, x: torch.Tensor):
        """Zeros for every layer, shaped as ``x``'s board with F
        channels."""
        shape = (x.shape[0], self.features) + tuple(x.shape[-2:])
        return ([x.new_zeros(shape) for _ in range(self.num_layers)],
                [x.new_zeros(shape) for _ in range(self.num_layers)])

    def forward(self, x: torch.Tensor, state=None):
        if state is None:
            state = self.initial_state(x)
        hs, cs = list(state[0]), list(state[1])
        for _ in range(self.num_repeats):
            for i, cell in enumerate(self.cells):
                inp = x if i == 0 else hs[i - 1]
                _, (hs[i], cs[i]) = cell(inp, (hs[i], cs[i]))
        return hs[-1], (hs, cs)
