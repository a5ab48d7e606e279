"""Hungry Geese net.

The port of ``handyrl_tpu/models/geese.py:GeeseNet``: a 17->F torus-conv
stem and ``layers`` residual torus-conv + GroupNorm blocks over the 17x7x11
board encoding; the policy is read out at the acting goose's head cell, the
value from the head cell and the board average.

The trunk's parameters live in the fused kernel's layout, stacked once:
``stem_w`` (3,3,17,F) and ``block_w`` (L,3,3,F,F) in flax's HWIO order,
with the GroupNorm scales and biases beside them. ``torus_impl='pallas'``
runs the trunk as the hand-written CUDA kernels (ops/geese_trunk.py: K1
forward, K2 backward under autograd; their plain versions on the CPU);
``'pad'`` and ``'halo'`` run it as plain torch
convs, layer by layer, on slices of the same tensors. All three are the
same function of the same parameters.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from . import register
from .blocks import TorusConv, to_nhwc
from ..ops.geese_trunk import (trunk_apply, trunk_forward,
                               trunk_params_from_geesenet)

TORUS_IMPLS = ('pad', 'halo', 'pallas')


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]):
    """flax's default kernel init: truncated normal in [-2, 2] std units,
    variance 1/fan_in after truncation."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        t.mul_(std)


@register('GeeseNet')
class GeeseNet(nn.Module):
    # constructor config and its defaults, in the JAX module's field order
    # (snapshots carry the non-default entries)
    DEFAULTS = {'filters': 32, 'layers': 12, 'norm_kind': 'group',
                'torus_impl': 'pad'}
    # the JAX module's fields a snapshot may carry that change nothing here:
    # pallas_tile is the batch tile of its TPU kernel (handyrl_tpu/models/
    # geese.py:73); the CUDA kernels take any batch
    FOREIGN_CONFIG = ('pallas_tile',)

    def __init__(self, filters: int = 32, layers: int = 12,
                 norm_kind: str = 'group', torus_impl: str = 'pad',
                 in_channels: int = 17,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm_kind != 'group':
            raise ValueError('the port implements GroupNorm only '
                             '(norm_kind=%r)' % (norm_kind,))
        if torus_impl not in TORUS_IMPLS:
            raise ValueError('unknown torus_impl %r' % (torus_impl,))
        self.filters, self.layers = int(filters), int(layers)
        self.norm_kind, self.torus_impl = norm_kind, torus_impl
        self.groups = min(8, self.filters)
        F, L = self.filters, self.layers
        self.stem_w = nn.Parameter(torch.empty(3, 3, in_channels, F))
        self.stem_scale = nn.Parameter(torch.empty(F))
        self.stem_bias = nn.Parameter(torch.empty(F))
        self.block_w = nn.Parameter(torch.empty(L, 3, 3, F, F))
        self.block_scale = nn.Parameter(torch.empty(L, F))
        self.block_bias = nn.Parameter(torch.empty(L, F))
        self.policy_w = nn.Parameter(torch.empty(F, 4))     # flax Dense_0
        self.value_w = nn.Parameter(torch.empty(2 * F, 1))  # flax Dense_1
        self.torus = (None if torus_impl == 'pallas'
                      else TorusConv(torus_impl, self.groups))
        self.reset_parameters(generator)

    def config(self) -> Dict[str, Any]:
        """Non-default constructor config (what a snapshot carries)."""
        return {k: getattr(self, k) for k, d in self.DEFAULTS.items()
                if getattr(self, k) != d}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax defaults: lecun_normal kernels, GroupNorm scale 1, bias 0."""
        cin, F = self.stem_w.shape[2], self.filters
        _lecun_normal_(self.stem_w, 9 * cin, generator)
        _lecun_normal_(self.block_w, 9 * F, generator)
        _lecun_normal_(self.policy_w, F, generator)
        _lecun_normal_(self.value_w, 2 * F, generator)
        with torch.no_grad():
            for p in (self.stem_scale, self.block_scale):
                p.fill_(1.0)
            for p in (self.stem_bias, self.block_bias):
                p.zero_()

    def init_hidden(self, batch_shape=None):
        return None

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(N,7,11,Cin) NHWC -> (N,7,11,F) NHWC."""
        if self.torus_impl == 'pallas':
            # under autograd the trunk is K1 forward, K2 backward
            fn = trunk_apply if torch.is_grad_enabled() else trunk_forward
            return fn(x.contiguous(), self.stem_w, self.stem_scale,
                      self.stem_bias, self.block_w, self.block_scale,
                      self.block_bias, groups=self.groups)
        h = torch.relu(self.torus(x.permute(0, 3, 1, 2), self.stem_w,
                                  self.stem_scale, self.stem_bias))
        for i in range(self.layers):
            h = torch.relu(h + self.torus(h, self.block_w[i],
                                          self.block_scale[i],
                                          self.block_bias[i]))
        return h.permute(0, 2, 3, 1)

    def forward(self, obs: torch.Tensor, hidden=None) -> Dict[str, Any]:
        x = to_nhwc(obs).to(self.stem_w.dtype)        # (..., 7, 11, 17)
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:])
        h = self.trunk(x)
        # pool features at the acting goose's head cell (channel 0 of obs)
        h_head = (h * x[..., :1]).sum(dim=(1, 2))     # (N, F)
        h_avg = h.mean(dim=(1, 2))                    # (N, F)
        policy = h_head @ self.policy_w
        value = torch.tanh(torch.cat([h_head, h_avg], dim=-1) @ self.value_w)
        return {'policy': policy.reshape(lead + (4,)),
                'value': value.reshape(lead + (1,))}


# ------------------------------------------------- flax params in and out

def params_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """The port's GeeseNet state dict from the JAX GeeseNet's param tree
    (nested dicts of numpy arrays, with or without the top-level 'params'
    key): ``TorusConv_0..L/{Conv_0/kernel, GroupNorm_0/{scale,bias}}``,
    ``Dense_0/kernel`` (F,4) and ``Dense_1/kernel`` (2F,1). Load it with
    ``net.load_state_dict(params_from_flax(tree))``."""
    p = tree['params'] if 'params' in tree else tree
    layers = sum(1 for k in p if k.startswith('TorusConv_')) - 1
    names = ('stem_w', 'stem_scale', 'stem_bias', 'block_w', 'block_scale',
             'block_bias')
    arrays = dict(zip(names, trunk_params_from_geesenet(p, layers)))
    arrays['policy_w'] = p['Dense_0']['kernel']
    arrays['value_w'] = p['Dense_1']['kernel']
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in arrays.items()}


def params_to_flax(net) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: the flax-shaped param tree
    ``{'params': {...}}`` of numpy arrays (what snapshots carry), from a
    GeeseNet or from a mapping of its parameter names to tensors (a state
    dict, or the Adam moments of one)."""
    t = dict(net) if isinstance(net, Mapping) else dict(net.named_parameters())

    def arr(v: torch.Tensor) -> np.ndarray:
        return v.detach().to('cpu', torch.float32).numpy().copy()

    p: Dict[str, Any] = {}
    convs = [(t['stem_w'], t['stem_scale'], t['stem_bias'])] + [
        (t['block_w'][i], t['block_scale'][i], t['block_bias'][i])
        for i in range(t['block_w'].shape[0])]
    for i, (w, s, b) in enumerate(convs):
        p['TorusConv_%d' % i] = {'Conv_0': {'kernel': arr(w)},
                                 'GroupNorm_0': {'scale': arr(s),
                                                 'bias': arr(b)}}
    p['Dense_0'] = {'kernel': arr(t['policy_w'])}
    p['Dense_1'] = {'kernel': arr(t['value_w'])}
    return {'params': p}
