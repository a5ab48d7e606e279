"""Geister net: recurrent DRC (Deep Repeated ConvLSTM) policy/value/return.

The port of ``handyrl_tpu/models/geister.py:GeisterNet``: the 18 scalar
features broadcast onto the 6x6 board and concatenated after the 7 board
planes (25 channels), a 3x3 conv stem (:class:`~.blocks.ConvBlock`), a
``drc_layers`` x ``drc_repeats`` DRC body, the move policy (4 x 36: the
dense head or the per-cell spatial one) beside the setup policy (70
logits of a dense layer over the side-to-move bit), a tanh value head and
a return head. PyTorch's convs throughout: the JAX package leaves this net
to XLA (no TPU kernel).

``norm_kind`` is the JAX module's: 'group' runs GroupNorm in the stem and
one-group GroupNorm in the heads; 'batch', 'batchstats' and 'layer' run
that norm everywhere. A 'batch' net keeps its running averages in buffers
(``*.norm.mean`` / ``*.norm.var``), which the snapshot carries as flax's
``batch_stats`` collection; the training forward (``train=True``) uses the
batch's statistics and reports the advanced averages
(``blocks.batch_stats_sink``).

The hidden state keeps the JAX layout at the module's boundary: ``(hs,
cs)``, lists of ``drc_layers`` (..., 6, 6, F) tensors each.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from . import register
from .blocks import (DRC, NORM_MODULE, ConvBlock, PolicyHead, ScalarHead,
                     SpatialPolicyHead, _reset_dense, compute_dtype_of,
                     linear)
from .tictactoe import FLAX_TO_TORCH, TORCH_TO_FLAX

BOARD_PLANES, SCALARS, SIDE = 7, 18, 6
N_MOVE, N_SET = 4 * SIDE * SIDE, 70
POLICY_HEADS = ('dense', 'spatial')


@register('GeisterNet')
class GeisterNet(nn.Module):
    # constructor config and its defaults, in the JAX module's field order
    # (snapshots carry the non-default entries)
    DEFAULTS = {'filters': 32, 'drc_layers': 3, 'drc_repeats': 3,
                'norm_kind': 'group', 'policy_head': 'dense',
                'init_kind': 'flax'}
    RECURRENT = True

    def __init__(self, filters: int = 32, drc_layers: int = 3,
                 drc_repeats: int = 3, norm_kind: str = 'group',
                 policy_head: str = 'dense', init_kind: str = 'flax',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm_kind not in ('group', 'batch', 'batchstats', 'layer'):
            raise ValueError('unknown norm_kind %r' % (norm_kind,))
        if policy_head not in POLICY_HEADS:
            raise ValueError('unknown policy_head %r' % (policy_head,))
        if init_kind not in ('flax', 'torch'):
            raise ValueError('unknown init_kind %r' % (init_kind,))
        self.filters, self.drc_layers = int(filters), int(drc_layers)
        self.drc_repeats = int(drc_repeats)
        self.norm_kind, self.policy_head = norm_kind, policy_head
        self.init_kind = init_kind
        F = self.filters
        # 'group' keeps the heads' one-group GroupNorm (the JAX module's
        # head_norm); the other kinds run in the heads too
        head_norm = 'group1' if norm_kind == 'group' else norm_kind
        self.stem = ConvBlock(BOARD_PLANES + SCALARS, F, norm_kind,
                              init_kind)
        self.body = DRC(F, self.drc_layers, F,
                        num_repeats=self.drc_repeats, init_kind=init_kind)
        if policy_head == 'spatial':
            self.move_head = SpatialPolicyHead(F, 8, 4, head_norm, init_kind)
        else:
            self.move_head = PolicyHead(F, 8, N_MOVE, SIDE * SIDE, init_kind)
        self.p_set = nn.Linear(1, N_SET)
        self.value_head = ScalarHead(F, 2, 1, SIDE * SIDE, head_norm,
                                     init_kind)
        self.return_head = ScalarHead(F, 2, 1, SIDE * SIDE, head_norm,
                                      init_kind)
        self.reset_parameters(generator)

    def config(self) -> Dict[str, Any]:
        """Non-default constructor config (what a snapshot carries)."""
        return {k: getattr(self, k) for k, d in self.DEFAULTS.items()
                if getattr(self, k) != d}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX module's init regime ``init_kind`` ('flax': lecun_normal
        kernels and zero biases; 'torch': uniform +-1/sqrt(fan_in)), norm
        scales 1 and biases 0, running averages 0 and 1."""
        self.stem.reset_parameters(generator)
        self.body.reset_parameters(generator)
        self.move_head.reset_parameters(generator)
        _reset_dense(self.p_set, generator, self.init_kind)
        self.value_head.reset_parameters(generator)
        self.return_head.reset_parameters(generator)

    def init_hidden(self, batch_shape=()):
        """Zero DRC state ``(hs, cs)``: lists of ``drc_layers`` distinct
        ``batch_shape + (6, 6, F)`` tensors on the parameters' device, in
        the compute dtype."""
        shape = tuple(batch_shape or ()) + (SIDE, SIDE, self.filters)
        w = self.p_set.weight
        dtype = compute_dtype_of(self) or w.dtype

        def mk():
            return torch.zeros(shape, dtype=dtype, device=w.device)
        return ([mk() for _ in range(self.drc_layers)],
                [mk() for _ in range(self.drc_layers)])

    def forward(self, obs, hidden=None, train: bool = False
                ) -> Dict[str, Any]:
        dtype = self.p_set.weight.dtype
        board = obs['board'].to(dtype)                  # (..., 7, 6, 6)
        scalar = obs['scalar'].to(dtype)                # (..., 18)
        lead = tuple(board.shape[:-3])
        board = board.reshape((-1,) + tuple(board.shape[-3:]))
        scalar = scalar.reshape(-1, SCALARS)
        n = board.shape[0]
        s_map = scalar[:, :, None, None].expand(n, SCALARS, SIDE, SIDE)
        x = torch.cat([board, s_map], dim=1)            # (N, 25, 6, 6)
        h = torch.relu(self.stem(x, train))
        state = None
        dt = compute_dtype_of(self)
        if hidden is not None:
            # (..., 6, 6, F) at the boundary -> (N, F, 6, 6); an fp32 or
            # bf16 state keeps its dtype (an fp32 one promotes the cells
            # to fp32, as in JAX), any other is taken in the params'
            state = tuple([t.reshape((n,) + tuple(t.shape[-3:]))
                           .permute(0, 3, 1, 2).to(
                               t.dtype if t.dtype in (torch.float32,
                                                      torch.bfloat16)
                               else dtype)
                           for t in part] for part in hidden)
        h, (hs, cs) = self.body(h, state)
        if self.policy_head == 'spatial':
            p_move = self.move_head(h, train)
        else:
            p_move = self.move_head(h)
        # setup-phase logits conditioned only on the side-to-move bit
        p_set = linear(self.p_set, scalar[:, :1], dt)
        policy = torch.cat([p_move, p_set], dim=-1)
        value = torch.tanh(self.value_head(h, train))
        ret = self.return_head(h, train)

        def out(t):
            return t.permute(0, 2, 3, 1).reshape(lead + (SIDE, SIDE,
                                                         self.filters))
        return {'policy': policy.reshape(lead + (N_MOVE + N_SET,)),
                'value': value.reshape(lead + (1,)),
                'return': ret.reshape(lead + (1,)),
                'hidden': ([out(t) for t in hs], [out(t) for t in cs])}


# ------------------------------------------------- flax params in and out

def _norm_leaves(prefix: str, flax_path: Tuple[str, ...], kind: str
                 ) -> List[Tuple[str, Tuple[str, ...], str, str]]:
    norm = flax_path + (NORM_MODULE[kind],)
    rows = [(prefix + 'norm.weight', norm + ('scale',), 'vector', 'params'),
            (prefix + 'norm.bias', norm + ('bias',), 'vector', 'params')]
    if kind == 'batch':
        rows += [(prefix + 'norm.mean', norm + ('mean',), 'vector',
                  'batch_stats'),
                 (prefix + 'norm.var', norm + ('var',), 'vector',
                  'batch_stats')]
    return rows


def _leaves(layers: int, norm_kind: str, policy_head: str
            ) -> List[Tuple[str, Tuple[str, ...], str, str]]:
    """(state-dict name, flax path, conversion, collection) of every leaf
    of ``GeisterNet().init``, in the flax init's module order."""
    head_norm = 'group1' if norm_kind == 'group' else norm_kind
    rows = [('stem.conv.weight', ('ConvBlock_0', 'Conv_0', 'kernel'),
             'conv', 'params')]
    rows += _norm_leaves('stem.', ('ConvBlock_0',), norm_kind)
    for i in range(layers):
        cell = ('DRC_0', 'ConvLSTMCell_%d' % i, 'Conv_0')
        rows += [('body.cells.%d.conv.weight' % i, cell + ('kernel',),
                  'conv', 'params'),
                 ('body.cells.%d.conv.bias' % i, cell + ('bias',), 'vector',
                  'params')]
    if policy_head == 'spatial':
        sp = ('SpatialPolicyHead_0',)
        rows += [('move_head.conv.weight', sp + ('Conv_0', 'kernel'), 'conv',
                  'params')]
        rows += _norm_leaves('move_head.', sp, head_norm)
        rows += [('move_head.out.weight', sp + ('Conv_1', 'kernel'), 'conv',
                  'params'),
                 ('move_head.out.bias', sp + ('Conv_1', 'bias'), 'vector',
                  'params')]
    else:
        ph = ('PolicyHead_0',)
        rows += [('move_head.conv.weight', ph + ('Conv_0', 'kernel'), 'conv',
                  'params'),
                 ('move_head.conv.bias', ph + ('Conv_0', 'bias'), 'vector',
                  'params'),
                 ('move_head.dense.weight', ph + ('Dense_0', 'kernel'),
                  'dense', 'params')]
    rows += [('p_set.weight', ('Dense_0', 'kernel'), 'dense', 'params'),
             ('p_set.bias', ('Dense_0', 'bias'), 'vector', 'params')]
    for name, mod in (('value_head.', 'ScalarHead_0'),
                      ('return_head.', 'ScalarHead_1')):
        rows += [(name + 'conv.weight', (mod, 'Conv_0', 'kernel'), 'conv',
                  'params')]
        rows += _norm_leaves(name, (mod,), head_norm)
        rows += [(name + 'dense.weight', (mod, 'Dense_0', 'kernel'), 'dense',
                  'params')]
    return rows


def _kind_of(names) -> str:
    """The norm kind of a stem norm's flax module name."""
    for kind in ('batch', 'batchstats', 'layer', 'group'):
        if NORM_MODULE[kind] in names:
            return kind
    raise ValueError('no known norm in %s' % sorted(names))


def params_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """The port's GeisterNet state dict from the JAX GeisterNet's
    variables (``{'params': ..., 'batch_stats': ...}``, or the bare param
    tree, as Adam's moments are): the running averages come in where the
    tree has a ``batch_stats`` collection. Load it with
    ``net.load_state_dict(...)``."""
    p = tree['params'] if 'params' in tree else tree
    stats = tree.get('batch_stats') if 'params' in tree else None
    layers = sum(1 for k in p['DRC_0'] if k.startswith('ConvLSTMCell_'))
    kind = _kind_of(p['ConvBlock_0'])
    head = 'spatial' if 'SpatialPolicyHead_0' in p else 'dense'
    out = {}
    for name, path, conv, coll in _leaves(layers, kind, head):
        if coll == 'batch_stats' and stats is None:
            continue
        leaf = p if coll == 'params' else stats
        for k in path:
            leaf = leaf[k]
        out[name] = FLAX_TO_TORCH[conv](leaf)
    return out


def params_to_flax(net, norm_kind: Optional[str] = None) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: ``{'params': {...}}`` of numpy
    arrays, with ``'batch_stats'`` where the source holds the running
    averages, from a GeisterNet (its parameters and buffers) or from a
    mapping of its state-dict names to tensors (a train state's params,
    or Adam's moments, which have no running averages). The state-dict
    names do not tell the stateless norm kinds apart, so a mapping takes
    the net's ``norm_kind`` (``model.param_trees`` passes it; without it,
    'batch' where running averages are present, else 'group')."""
    if isinstance(net, Mapping):
        t = dict(net)
    else:
        norm_kind = net.norm_kind
        t = dict(net.named_parameters())
        t.update(net.named_buffers())
    if norm_kind is None:
        norm_kind = 'batch' if 'stem.norm.mean' in t else 'group'
    layers = sum(1 for k in t if k.startswith('body.cells.')
                 and k.endswith('.conv.weight'))
    head = 'spatial' if 'move_head.out.weight' in t else 'dense'
    out: Dict[str, Any] = {}
    for name, path, conv, coll in _leaves(layers, norm_kind, head):
        if name not in t:     # Adam's moments hold no running averages
            continue
        node = out.setdefault(coll, {})
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = TORCH_TO_FLAX[conv](
            t[name].detach().to('cpu', torch.float32))
    return out
