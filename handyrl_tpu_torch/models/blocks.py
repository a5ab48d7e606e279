"""Shared torch building blocks.

Model convention (as in the JAX package): ``module(obs, hidden)`` returns a
dict with 'policy' (logits) and 'value' (shape (..., 1)); observations
arrive channel-first (..., C, H, W) exactly as environments emit them.
Normalization is GroupNorm with ``min(8, F)`` groups and flax's eps 1e-6,
statistics in fp32.
"""

from __future__ import annotations

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
