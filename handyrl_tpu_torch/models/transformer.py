"""Transformer policy net over board cells: GeeseFormer.

The port of ``handyrl_tpu/models/transformer.py``. The 77 cells of the
Hungry Geese board become tokens (each cell's 17 channels through a dense
embedding, plus a learned position embedding), padded to ``pad_to`` = 80
tokens, then ``layers`` pre-norm transformer blocks (LayerNorm, multi-head
self-attention, residual; LayerNorm, a GELU MLP of width 2 x dim,
residual), a final LayerNorm, and GeeseNet's readout: the policy at the
acting goose's head cell (channel 0 of the observation), the value from
the head cell and the mean over all tokens.

As in the JAX module: the 3 padded tokens are not masked (they attend, are
attended to and count in the mean over 80 tokens); flax's LayerNorm eps is
1e-6; ``nn.gelu`` is the tanh approximation; the position embedding is
drawn from normal(0.02); the attention's qkv and output projections have
no bias, the embedding and MLP layers have one. Attention is plain PyTorch
(two products and a softmax), as the JAX package's ``full_attention`` is
plain XLA: no TPU kernel stands behind it, so the port has no hand kernel
here. ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``), as ``nn.remat``. The JAX module's ``mesh``
runs the attention as ring attention across devices; the port's
multi-device plane is ROADMAP.md section 1 item 9, so a mesh raises.

The compute dtype (``blocks.set_compute_dtype``) is flax's module dtype:
the dense layers take bf16 inputs and kernels, the LayerNorms fp32
statistics and bf16 outputs, the position embedding is cast to it.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import register
from .blocks import (LN_EPS, _moments, _reset_dense, compute_dtype_of,
                     linear)

CHANNELS, CELLS = 17, 77
MESH_REFUSAL = ('GeeseFormer(mesh=...): ring attention over a device mesh '
                'is the multi-device plane, ROADMAP.md section 1 item 9, '
                'not ported')


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """The JAX package's ``full_attention``: q, k, v (B, T, H, D) ->
    softmax(q k^T / sqrt(D)) v, (B, T, H, D), in the inputs' dtype."""
    s = torch.einsum('bqhd,bkhd->bhqk', q, k) * q.shape[-1] ** -0.5
    return torch.einsum('bhqk,bkhd->bqhd', torch.softmax(s, dim=-1), v)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis: fp32 statistics (the fast
    variance), eps 1e-6, scale ('weight') and bias, output in the compute
    dtype (else the input's)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu, var = _moments(x, (-1,))
        y = (x.float() - mu) * (torch.rsqrt(var + LN_EPS)
                                * self.weight.float())
        return (y + self.bias.float()).to(compute_dtype_of(self) or x.dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention over (B, T, F) tokens: one qkv projection
    to 3 x dim (no bias), ``heads`` heads, an output projection to F (no
    bias)."""

    def __init__(self, features: int, heads: int = 4, dim: int = 64):
        super().__init__()
        self.heads, self.dim = int(heads), int(dim)
        self.qkv = nn.Linear(features, 3 * self.dim, bias=False)
        self.out = nn.Linear(self.dim, features, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype_of(self)
        B, T, _ = x.shape
        q, k, v = (t.reshape(B, T, self.heads, self.dim // self.heads)
                   for t in linear(self.qkv, x, dt).chunk(3, dim=-1))
        return linear(self.out, full_attention(q, k, v)
                      .reshape(B, T, self.dim), dt)


class Block(nn.Module):
    """Pre-norm transformer block: x + attn(LN(x)), then h + mlp(LN(h))
    with a dense 2 x dim GELU (tanh) MLP."""

    def __init__(self, features: int, heads: int, dim: int):
        super().__init__()
        self.ln1 = LayerNorm(features)
        self.attn = SelfAttention(features, heads, dim)
        self.ln2 = LayerNorm(features)
        self.mlp1 = nn.Linear(features, 2 * dim)
        self.mlp2 = nn.Linear(2 * dim, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype_of(self)
        h = x + self.attn(self.ln1(x))
        m = F.gelu(linear(self.mlp1, self.ln2(h), dt), approximate='tanh')
        return h + linear(self.mlp2, m, dt)


@register('GeeseFormer')
class GeeseFormer(nn.Module):
    """Attention policy/value net for Hungry Geese (obs (..., 17, 7, 11))."""
    # constructor config and its defaults, in the JAX module's field order
    # (snapshots carry the non-default entries)
    DEFAULTS = {'dim': 64, 'layers': 4, 'heads': 4, 'pad_to': 80,
                'ring_axis': 'model', 'remat': False}

    def __init__(self, dim: int = 64, layers: int = 4, heads: int = 4,
                 pad_to: int = 80, mesh: Optional[object] = None,
                 ring_axis: str = 'model', remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mesh is not None:
            raise ValueError(MESH_REFUSAL)
        if pad_to < CELLS:
            raise ValueError('pad_to %d is below the board\'s %d cells'
                             % (pad_to, CELLS))
        self.dim, self.layers, self.heads = int(dim), int(layers), int(heads)
        self.pad_to, self.ring_axis = int(pad_to), ring_axis
        self.remat = bool(remat)
        self.embed = nn.Linear(CHANNELS, self.dim)
        self.pos_embed = nn.Parameter(torch.empty(self.pad_to, self.dim))
        self.blocks = nn.ModuleList(Block(self.dim, self.heads, self.dim)
                                    for _ in range(self.layers))
        self.norm = LayerNorm(self.dim)
        self.policy = nn.Linear(self.dim, 4, bias=False)
        self.value = nn.Linear(2 * self.dim, 1, bias=False)
        self.reset_parameters(generator)

    def config(self) -> Dict[str, Any]:
        """Non-default constructor config (what a snapshot carries)."""
        return {k: getattr(self, k) for k, d in self.DEFAULTS.items()
                if getattr(self, k) != d}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax defaults: lecun_normal dense kernels, zero biases,
        LayerNorm scale 1 and bias 0, the position embedding normal(0.02)."""
        for layer in self._dense_layers():
            _reset_dense(layer, generator)
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
            for ln in [self.norm] + [m for b in self.blocks
                                     for m in (b.ln1, b.ln2)]:
                ln.weight.fill_(1.0)
                ln.bias.zero_()

    def _dense_layers(self) -> List[nn.Linear]:
        out = [self.embed]
        for b in self.blocks:
            out += [b.attn.qkv, b.attn.out, b.mlp1, b.mlp2]
        return out + [self.policy, self.value]

    def init_hidden(self, batch_shape=None):
        return None

    def forward(self, obs: torch.Tensor, hidden=None) -> Dict[str, Any]:
        dt = compute_dtype_of(self)
        # the observation stays in the params' dtype: the head mask below
        # is the fp32 observation, as in JAX
        x = obs.to(self.pos_embed.dtype)
        lead = x.shape[:-3]
        x = x.reshape((-1, CHANNELS, CELLS))
        cells = x.transpose(1, 2)                         # (B, 77, 17)
        cells = F.pad(cells, (0, 0, 0, self.pad_to - CELLS))
        tokens = linear(self.embed, cells, dt)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                tokens = checkpoint(block, tokens, use_reentrant=False)
            else:
                tokens = block(tokens)
        tokens = self.norm(tokens)
        h_head = (tokens * cells[..., :1]).sum(dim=1)    # own head: channel 0
        h_avg = tokens.mean(dim=1)
        policy = linear(self.policy, h_head, dt)
        value = torch.tanh(linear(self.value, torch.cat([h_head, h_avg],
                                                        dim=-1), dt))
        return {'policy': policy.reshape(lead + (4,)),
                'value': value.reshape(lead + (1,))}


# ------------------------------------------------- flax params in and out

def _block_name(tree: Dict, i: int) -> str:
    """flax names block i 'CheckpointBlock_i' under nn.remat."""
    return ('CheckpointBlock_%d' if 'CheckpointBlock_0' in tree
            else 'Block_%d') % i


def _leaves(layers: int, remat: bool) -> List[Tuple[str, Tuple[str, ...],
                                                    str]]:
    """(state-dict name, flax path, conversion) of every parameter, in the
    flax init's order."""
    rows = [('embed.weight', ('Dense_0', 'kernel'), 'dense'),
            ('embed.bias', ('Dense_0', 'bias'), 'vector'),
            ('pos_embed', ('pos_embed',), 'vector')]
    block = 'CheckpointBlock_%d' if remat else 'Block_%d'
    for i in range(layers):
        b, f = 'blocks.%d.' % i, block % i
        rows += [(b + 'ln1.weight', (f, 'LayerNorm_0', 'scale'), 'vector'),
                 (b + 'ln1.bias', (f, 'LayerNorm_0', 'bias'), 'vector'),
                 (b + 'attn.qkv.weight', (f, 'SelfAttention_0', 'Dense_0',
                                          'kernel'), 'dense'),
                 (b + 'attn.out.weight', (f, 'SelfAttention_0', 'Dense_1',
                                          'kernel'), 'dense'),
                 (b + 'ln2.weight', (f, 'LayerNorm_1', 'scale'), 'vector'),
                 (b + 'ln2.bias', (f, 'LayerNorm_1', 'bias'), 'vector'),
                 (b + 'mlp1.weight', (f, 'Dense_0', 'kernel'), 'dense'),
                 (b + 'mlp1.bias', (f, 'Dense_0', 'bias'), 'vector'),
                 (b + 'mlp2.weight', (f, 'Dense_1', 'kernel'), 'dense'),
                 (b + 'mlp2.bias', (f, 'Dense_1', 'bias'), 'vector')]
    return rows + [('norm.weight', ('LayerNorm_0', 'scale'), 'vector'),
                   ('norm.bias', ('LayerNorm_0', 'bias'), 'vector'),
                   ('policy.weight', ('Dense_1', 'kernel'), 'dense'),
                   ('value.weight', ('Dense_2', 'kernel'), 'dense')]


def params_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """The port's GeeseFormer state dict from the JAX module's param tree
    (nested dicts of numpy arrays, with or without the top-level 'params'
    key; blocks named 'Block_i', or 'CheckpointBlock_i' under remat). A
    flax Dense kernel (in, out) is the transposed Linear weight."""
    p = tree['params'] if 'params' in tree else tree
    remat = 'CheckpointBlock_0' in p
    layers = sum(1 for k in p if k.startswith(('Block_',
                                               'CheckpointBlock_')))
    out = {}
    for name, path, kind in _leaves(layers, remat):
        leaf = p
        for k in path:
            leaf = leaf[k]
        a = np.asarray(leaf, np.float32)
        out[name] = torch.from_numpy(np.array(a.T if kind == 'dense' else a,
                                              order='C'))
    return out


def params_to_flax(net, remat: Optional[bool] = None) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: ``{'params': {...}}`` of numpy
    arrays in the flax init's module order, from a GeeseFormer or from a
    mapping of its parameter names to tensors (a state dict, or the Adam
    moments of one), the blocks named 'CheckpointBlock_i' for a ``remat``
    net (``model.param_trees`` passes the net's; a GeeseFormer's own by
    default, False for a mapping)."""
    if isinstance(net, Mapping):
        t = dict(net)
    else:
        t = dict(net.named_parameters())
        remat = net.remat if remat is None else remat
    layers = sum(1 for k in t if k.startswith('blocks.')
                 and k.endswith('.ln1.weight'))
    p: Dict[str, Any] = {}
    for name, path, kind in _leaves(layers, remat):
        node = p
        for k in path[:-1]:
            node = node.setdefault(k, {})
        a = t[name].detach().to('cpu', torch.float32).numpy()
        node[path[-1]] = np.ascontiguousarray(a.T if kind == 'dense'
                                              else a.copy())
    return {'params': p}
