"""TicTacToe policy/value net.

The port of ``handyrl_tpu/models/tictactoe.py:SimpleConv2dModel``: a
3->F zero-padded 3x3 stem conv (with bias) and ``layers`` conv + GroupNorm
blocks, each followed by a ReLU, then a 9-way policy head and a tanh value
head over the 3x3 board. Its convs are plain ``F.conv2d`` calls: the JAX
package leaves them to XLA (no TPU kernel), so the port has no hand kernel
here. Only the width the JAX package defines (filters 32, 3 blocks) is
ever trained; other widths build for tests. ``models/connect_four.py``'s
ConnectFourNet is the same net on the 6x7 board (the class attributes
``ROWS``, ``COLS``, ``ACTIONS``), and shares the snapshot format below.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import register
from .blocks import (ConvBlock, PolicyHead, ScalarHead, compute_dtype_of,
                     conv2d, lecun_normal_)

PLANES = 3


@register('SimpleConv2dModel')
class SimpleConv2dModel(nn.Module):
    # constructor config and its defaults, in the JAX module's field order
    # (snapshots carry the non-default entries)
    DEFAULTS = {'filters': 32, 'layers': 3}
    # the board and the policy's width
    ROWS, COLS, ACTIONS = 3, 3, 9

    def __init__(self, filters: Optional[int] = None,
                 layers: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.filters = int(self.DEFAULTS['filters'] if filters is None
                           else filters)
        self.layers = int(self.DEFAULTS['layers'] if layers is None
                          else layers)
        F, cells = self.filters, self.ROWS * self.COLS
        self.conv = nn.Conv2d(PLANES, F, 3, padding=1)
        self.blocks = nn.ModuleList(ConvBlock(F, F)
                                    for _ in range(self.layers))
        self.policy_head = PolicyHead(F, 2, self.ACTIONS, cells)
        self.value_head = ScalarHead(F, 1, 1, cells)
        self.reset_parameters(generator)

    def config(self) -> Dict[str, Any]:
        """Non-default constructor config (what a snapshot carries)."""
        return {k: getattr(self, k) for k, d in self.DEFAULTS.items()
                if getattr(self, k) != d}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax defaults: lecun_normal kernels, zero biases, GroupNorm scale
        1 and bias 0."""
        lecun_normal_(self.conv.weight, 9 * PLANES, generator)
        with torch.no_grad():
            self.conv.bias.zero_()
        for block in self.blocks:
            block.reset_parameters(generator)
        self.policy_head.reset_parameters(generator)
        self.value_head.reset_parameters(generator)

    def init_hidden(self, batch_shape=None):
        return None

    def forward(self, obs: torch.Tensor, hidden=None) -> Dict[str, Any]:
        x = obs.to(self.conv.weight.dtype)            # (..., 3, ROWS, COLS)
        lead = x.shape[:-3]
        h = torch.relu(conv2d(self.conv, x.reshape((-1,) + x.shape[-3:]),
                              compute_dtype_of(self)))
        for block in self.blocks:
            h = torch.relu(block(h))
        policy = self.policy_head(h)
        value = torch.tanh(self.value_head(h))
        return {'policy': policy.reshape(lead + (self.ACTIONS,)),
                'value': value.reshape(lead + (1,))}


# ------------------------------------------------- flax params in and out

# flax leaves <-> torch tensors: a conv kernel is HWIO in flax and OIHW in
# torch, a Dense kernel (in, out) is the transposed Linear weight (the heads
# flatten in flax's order), a bias, scale or norm bias is the same vector
FLAX_TO_TORCH = {   # each a fresh C-order copy
    'conv': lambda a: torch.from_numpy(np.array(
        np.asarray(a, np.float32).transpose(3, 2, 0, 1), order='C')),
    'dense': lambda a: torch.from_numpy(np.array(
        np.asarray(a, np.float32).T, order='C')),
    'vector': lambda a: torch.from_numpy(np.array(a, dtype=np.float32)),
}
TORCH_TO_FLAX = {
    'conv': lambda t: np.ascontiguousarray(t.permute(2, 3, 1, 0).numpy()),
    'dense': lambda t: np.ascontiguousarray(t.t().numpy()),
    'vector': lambda t: t.numpy().copy(),
}


def _leaves(layers: int) -> List[Tuple[str, Tuple[str, ...], str]]:
    """(state-dict name, flax path, conversion) of every parameter: the
    leaves of ``SimpleConv2dModel().init`` (and ``ConnectFourNet().init``)
    at ``layers`` blocks, 18 at 3."""
    rows = [('conv.weight', ('Conv_0', 'kernel'), 'conv'),
            ('conv.bias', ('Conv_0', 'bias'), 'vector')]
    for i in range(layers):
        b, f = 'blocks.%d.' % i, 'ConvBlock_%d' % i
        rows += [(b + 'conv.weight', (f, 'Conv_0', 'kernel'), 'conv'),
                 (b + 'norm.weight', (f, 'GroupNorm_0', 'scale'), 'vector'),
                 (b + 'norm.bias', (f, 'GroupNorm_0', 'bias'), 'vector')]
    p, v = 'PolicyHead_0', 'ScalarHead_0'
    rows += [('policy_head.conv.weight', (p, 'Conv_0', 'kernel'), 'conv'),
             ('policy_head.conv.bias', (p, 'Conv_0', 'bias'), 'vector'),
             ('policy_head.dense.weight', (p, 'Dense_0', 'kernel'), 'dense'),
             ('value_head.conv.weight', (v, 'Conv_0', 'kernel'), 'conv'),
             ('value_head.norm.weight', (v, 'GroupNorm_0', 'scale'),
              'vector'),
             ('value_head.norm.bias', (v, 'GroupNorm_0', 'bias'), 'vector'),
             ('value_head.dense.weight', (v, 'Dense_0', 'kernel'), 'dense')]
    return rows


def params_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """The port's SimpleConv2dModel (or ConnectFourNet) state dict from the
    JAX model's param
    tree (nested dicts of numpy arrays, with or without the top-level
    'params' key). Load it with ``net.load_state_dict(...)``."""
    p = tree['params'] if 'params' in tree else tree
    layers = sum(1 for k in p if k.startswith('ConvBlock_'))
    out = {}
    for name, path, kind in _leaves(layers):
        leaf = p
        for k in path:
            leaf = leaf[k]
        out[name] = FLAX_TO_TORCH[kind](leaf)
    return out


def params_to_flax(net) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: ``{'params': {...}}`` of numpy
    arrays, from a SimpleConv2dModel (or ConnectFourNet) or from a mapping of its parameter
    names to tensors (a state dict, or the Adam moments of one)."""
    t = dict(net) if isinstance(net, Mapping) else dict(net.named_parameters())
    layers = sum(1 for k in t if k.endswith('.conv.weight')
                 and k.startswith('blocks.'))
    p: Dict[str, Any] = {}
    for name, path, kind in _leaves(layers):
        node = p
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = TORCH_TO_FLAX[kind](
            t[name].detach().to('cpu', torch.float32))
    return {'params': p}
