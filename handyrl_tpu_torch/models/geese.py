"""Hungry Geese nets.

The port of ``handyrl_tpu/models/geese.py``. ``GeeseNet``: a 17->F torus-conv
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

``norm_kind`` is the JAX module's ('group', 'batch', 'batchstats',
'layer'; the kernel trunk runs 'group' alone, as the TPU kernel does).
In a bf16 compute dtype (``blocks.set_compute_dtype``) the trunk runs in
bf16 (the kernel trunk's bf16 form), the head-cell readout multiplies by
the fp32 observation (so ``h_head`` is fp32, as in JAX, until the dense
layers cast it) and the outputs are bf16. A
'batch' net keeps its running averages in the buffers ``stem_mean``,
``stem_var``, ``block_mean`` (L, F) and ``block_var``, flax's
``batch_stats`` ``TorusConv_i/BatchNorm_0/{mean, var}`` in a snapshot.

``GeeseNetLSTM``: the recurrent net (``env_args.net_kind: 'lstm'``), a
torus-conv stem of ``1 + stem_layers`` convs (residual after the first),
a :class:`~.blocks.ConvLSTMCell` carrying ``(h, c)`` across plies, and
GeeseNet's head readout. The JAX package runs no trunk kernel for it
(its TorusConv has 'pad' and 'halo' only), so neither does the port: its
convs are PyTorch's. The hidden state keeps the JAX package's layout at
the module's boundary, a tuple ``(h, c)`` of (..., 7, 11, F) tensors, so
requests over the wire carry the same arrays in both packages.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from . import register
from .blocks import (NORM_MODULE, ConvLSTMCell, TorusConv, compute_dtype_of,
                     dense, lecun_normal_, to_nhwc)
from ..ops.geese_trunk import (trunk_apply, trunk_params_from_geesenet,
                               trunk_serve)

TORUS_IMPLS = ('pad', 'halo', 'pallas')
NORM_KINDS = ('group', 'batch', 'batchstats', 'layer')


def _trunk_params(net: nn.Module, in_channels: int, layers: int,
                  norm_kind: str) -> None:
    """The stacked trunk parameters (and a 'batch' net's running
    averages) of a GeeseNet or GeeseNetLSTM stem of ``1 + layers`` torus
    convs."""
    if norm_kind not in NORM_KINDS:
        raise ValueError('unknown norm_kind %r' % (norm_kind,))
    F = net.filters
    net.stem_w = nn.Parameter(torch.empty(3, 3, in_channels, F))
    net.stem_scale = nn.Parameter(torch.empty(F))
    net.stem_bias = nn.Parameter(torch.empty(F))
    net.block_w = nn.Parameter(torch.empty(layers, 3, 3, F, F))
    net.block_scale = nn.Parameter(torch.empty(layers, F))
    net.block_bias = nn.Parameter(torch.empty(layers, F))
    if norm_kind == 'batch':
        net.register_buffer('stem_mean', torch.zeros(F))
        net.register_buffer('stem_var', torch.ones(F))
        net.register_buffer('block_mean', torch.zeros(layers, F))
        net.register_buffer('block_var', torch.ones(layers, F))


def _reset_trunk(net: nn.Module, generator: Optional[torch.Generator]):
    cin, F = net.stem_w.shape[2], net.filters
    lecun_normal_(net.stem_w, 9 * cin, generator)
    lecun_normal_(net.block_w, 9 * F, generator)
    with torch.no_grad():
        for p in (net.stem_scale, net.block_scale):
            p.fill_(1.0)
        for p in (net.stem_bias, net.block_bias):
            p.zero_()
        if net.norm_kind == 'batch':
            for p in (net.stem_mean, net.block_mean):
                p.zero_()
            for p in (net.stem_var, net.block_var):
                p.fill_(1.0)


def _torus_trunk(net: nn.Module, x: torch.Tensor, train: bool
                 ) -> torch.Tensor:
    """The stem and residual blocks as plain torch convs on NCHW."""
    h = torch.relu(net.torus(x, net.stem_w, net.stem_scale, net.stem_bias,
                             net, ('stem_mean', 'stem_var'), None, train))
    for i in range(net.block_w.shape[0]):
        h = torch.relu(h + net.torus(h, net.block_w[i], net.block_scale[i],
                                     net.block_bias[i], net,
                                     ('block_mean', 'block_var'), i, train))
    return h


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
        if torus_impl not in TORUS_IMPLS:
            raise ValueError('unknown torus_impl %r' % (torus_impl,))
        if torus_impl == 'pallas' and norm_kind != 'group':
            # as the JAX package's GeeseNet: the kernel trunk is GroupNorm
            raise ValueError("torus_impl='pallas' implements GroupNorm "
                             "only (norm_kind=%r)" % (norm_kind,))
        self.filters, self.layers = int(filters), int(layers)
        self.norm_kind, self.torus_impl = norm_kind, torus_impl
        self.groups = min(8, self.filters)
        F = self.filters
        _trunk_params(self, in_channels, self.layers, norm_kind)
        self.policy_w = nn.Parameter(torch.empty(F, 4))     # flax Dense_0
        self.value_w = nn.Parameter(torch.empty(2 * F, 1))  # flax Dense_1
        self.torus = (None if torus_impl == 'pallas'
                      else TorusConv(torus_impl, self.groups, norm_kind))
        self.reset_parameters(generator)

    def config(self) -> Dict[str, Any]:
        """Non-default constructor config (what a snapshot carries)."""
        return {k: getattr(self, k) for k, d in self.DEFAULTS.items()
                if getattr(self, k) != d}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax defaults: lecun_normal kernels, norm scale 1, bias 0
        (running averages 0 and 1)."""
        F = self.filters
        _reset_trunk(self, generator)
        lecun_normal_(self.policy_w, F, generator)
        lecun_normal_(self.value_w, 2 * F, generator)

    def init_hidden(self, batch_shape=None):
        return None

    def trunk(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(N,7,11,Cin) NHWC -> (N,7,11,F) NHWC, in the compute dtype."""
        if self.torus_impl == 'pallas':
            # under autograd the trunk is K1 forward, K2 backward; without
            # it K1's serving form, the registered operator; x's dtype
            # picks the kernels' form
            dt = compute_dtype_of(self)
            if dt is not None:
                x = x.to(dt)
            fn = trunk_apply if torch.is_grad_enabled() else trunk_serve
            return fn(x.contiguous(), self.stem_w, self.stem_scale,
                      self.stem_bias, self.block_w, self.block_scale,
                      self.block_bias, groups=self.groups)
        return _torus_trunk(self, x.permute(0, 3, 1, 2),
                            train).permute(0, 2, 3, 1)

    def forward(self, obs: torch.Tensor, hidden=None,
                train: bool = False) -> Dict[str, Any]:
        # the observation stays in the params' dtype: the head mask below
        # is the fp32 observation, as in JAX
        x = to_nhwc(obs).to(self.stem_w.dtype)        # (..., 7, 11, 17)
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:])
        h = self.trunk(x, train)
        dt = compute_dtype_of(self)
        # pool features at the acting goose's head cell (channel 0 of obs)
        h_head = (h * x[..., :1]).sum(dim=(1, 2))     # (N, F)
        h_avg = h.mean(dim=(1, 2))                    # (N, F)
        policy = dense(h_head, self.policy_w, dt)
        value = torch.tanh(dense(torch.cat([h_head, h_avg], dim=-1),
                                 self.value_w, dt))
        return {'policy': policy.reshape(lead + (4,)),
                'value': value.reshape(lead + (1,))}


@register('GeeseNetLSTM')
class GeeseNetLSTM(nn.Module):
    """The recurrent Hungry Geese net (BASELINE.md's LSTM configuration):
    ``module(obs, hidden)`` returns 'policy', 'value' and 'hidden', the
    next ``(h, c)``; a None ``hidden`` starts from zeros."""
    DEFAULTS = {'filters': 32, 'stem_layers': 4, 'norm_kind': 'group',
                'torus_impl': 'pad'}
    RECURRENT = True

    def __init__(self, filters: int = 32, stem_layers: int = 4,
                 norm_kind: str = 'group', torus_impl: str = 'pad',
                 in_channels: int = 17,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if torus_impl not in ('pad', 'halo'):
            # as the JAX package's TorusConv, which GeeseNetLSTM's stem is
            raise ValueError('GeeseNetLSTM runs torus_impl \'pad\' or '
                             '\'halo\' (got %r): no trunk kernel fuses its '
                             'stem' % (torus_impl,))
        self.filters, self.stem_layers = int(filters), int(stem_layers)
        self.norm_kind, self.torus_impl = norm_kind, torus_impl
        self.groups = min(8, self.filters)
        F = self.filters
        _trunk_params(self, in_channels, self.stem_layers, norm_kind)
        self.lstm = ConvLSTMCell(F, F)
        self.policy_w = nn.Parameter(torch.empty(F, 4))     # flax Dense_0
        self.value_w = nn.Parameter(torch.empty(2 * F, 1))  # flax Dense_1
        self.torus = TorusConv(torus_impl, self.groups, norm_kind)
        self.reset_parameters(generator)

    def config(self) -> Dict[str, Any]:
        """Non-default constructor config (what a snapshot carries)."""
        return {k: getattr(self, k) for k, d in self.DEFAULTS.items()
                if getattr(self, k) != d}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax defaults: lecun_normal kernels, zero biases, norm scale 1
        and bias 0 (running averages 0 and 1)."""
        F = self.filters
        _reset_trunk(self, generator)
        self.lstm.reset_parameters(generator)
        lecun_normal_(self.policy_w, F, generator)
        lecun_normal_(self.value_w, 2 * F, generator)

    def init_hidden(self, batch_shape=()):
        """Zeros ``(h, c)``, each ``batch_shape + (7, 11, F)``, on the
        parameters' device in the compute dtype (two tensors, as the JAX
        package's two arrays)."""
        shape = tuple(batch_shape or ()) + (7, 11, self.filters)
        w = self.stem_w
        dtype = compute_dtype_of(self) or w.dtype
        return (torch.zeros(shape, dtype=dtype, device=w.device),
                torch.zeros(shape, dtype=dtype, device=w.device))

    def forward(self, obs: torch.Tensor, hidden=None,
                train: bool = False) -> Dict[str, Any]:
        x = obs.to(self.stem_w.dtype)                  # (..., 17, 7, 11)
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:])
        h = _torus_trunk(self, x, train)
        dt = compute_dtype_of(self)
        if hidden is None:
            hidden = self.init_hidden((x.shape[0],))
        # the state crosses the boundary as (..., 7, 11, F), in its own
        # dtype: an fp32 state (the learner's gated one) promotes the cell
        # to fp32 as in JAX
        h_prev, c_prev = (t.reshape((-1,) + tuple(t.shape[-3:]))
                          .permute(0, 3, 1, 2) for t in hidden)
        h, (h_next, c_next) = self.lstm(h, (h_prev, c_prev))
        # pool features at the acting goose's head cell (channel 0 of obs)
        h_head = (h * x[:, :1]).sum(dim=(2, 3))       # (N, F)
        h_avg = h.mean(dim=(2, 3))                    # (N, F)
        policy = dense(h_head, self.policy_w, dt)
        value = torch.tanh(dense(torch.cat([h_head, h_avg], dim=-1),
                                 self.value_w, dt))

        def out(t):
            return t.permute(0, 2, 3, 1).reshape(lead + tuple(
                t.shape[-2:]) + (self.filters,))
        return {'policy': policy.reshape(lead + (4,)),
                'value': value.reshape(lead + (1,)),
                'hidden': (out(h_next), out(c_next))}


# ------------------------------------------------- flax params in and out

def _norm_name(stem: Dict) -> str:
    for kind in ('batch', 'batchstats', 'layer', 'group'):
        if NORM_MODULE[kind] in stem:
            return kind
    raise ValueError('no known norm in %s' % sorted(stem))


def params_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """The port's GeeseNet (or GeeseNetLSTM) state dict from the JAX
    GeeseNet's variables (nested dicts of numpy arrays, with or without
    the top-level 'params' key): ``TorusConv_0..L/{Conv_0/kernel,
    <norm>_0/{scale,bias}}``, ``Dense_0/kernel`` (F,4) and
    ``Dense_1/kernel`` (2F,1); a 'batch' net's ``batch_stats``
    (``TorusConv_i/BatchNorm_0/{mean,var}``) where the tree has them.
    Load it with ``net.load_state_dict(params_from_flax(tree))``."""
    p = tree['params'] if 'params' in tree else tree
    stats = tree.get('batch_stats') if 'params' in tree else None
    layers = sum(1 for k in p if k.startswith('TorusConv_')) - 1
    norm = NORM_MODULE[_norm_name(p['TorusConv_0'])]
    names = ('stem_w', 'stem_scale', 'stem_bias', 'block_w', 'block_scale',
             'block_bias')
    arrays = dict(zip(names, trunk_params_from_geesenet(p, layers, norm)))
    if stats is not None:
        for part in ('mean', 'var'):
            arrays['stem_' + part] = stats['TorusConv_0'][norm][part]
            arrays['block_' + part] = np.stack(
                [np.asarray(stats['TorusConv_%d' % i][norm][part])
                 for i in range(1, layers + 1)])
    arrays['policy_w'] = p['Dense_0']['kernel']
    arrays['value_w'] = p['Dense_1']['kernel']
    if 'ConvLSTMCell_0' in p:
        # HWIO over [x, h] -> OIHW over the same concatenation
        cell = p['ConvLSTMCell_0']['Conv_0']
        arrays['lstm.conv.weight'] = np.asarray(
            cell['kernel'], np.float32).transpose(3, 2, 0, 1)
        arrays['lstm.conv.bias'] = cell['bias']
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in arrays.items()}


def params_to_flax(net, norm_kind: Optional[str] = None) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: the flax-shaped variables
    ``{'params': {...}}`` of numpy arrays (what snapshots carry), in the
    flax init's module order, with ``'batch_stats'`` where the source holds
    running averages, from a GeeseNet, a GeeseNetLSTM (parameters and
    buffers) or from a mapping of its state-dict names to tensors (a train
    state's params, or the Adam moments of one). A mapping takes the net's
    ``norm_kind`` (``model.param_trees`` passes it; without it, 'batch'
    where running averages are present, else 'group')."""
    if isinstance(net, Mapping):
        t = dict(net)
    else:
        norm_kind = net.norm_kind
        t = dict(net.named_parameters())
        t.update(net.named_buffers())
    if norm_kind is None:
        norm_kind = 'batch' if 'stem_mean' in t else 'group'
    norm = NORM_MODULE[norm_kind]

    def arr(v: torch.Tensor) -> np.ndarray:
        return v.detach().to('cpu', torch.float32).numpy().copy()

    p: Dict[str, Any] = {}
    convs = [(t['stem_w'], t['stem_scale'], t['stem_bias'])] + [
        (t['block_w'][i], t['block_scale'][i], t['block_bias'][i])
        for i in range(t['block_w'].shape[0])]
    for i, (w, s, b) in enumerate(convs):
        p['TorusConv_%d' % i] = {'Conv_0': {'kernel': arr(w)},
                                 norm: {'scale': arr(s), 'bias': arr(b)}}
    if 'lstm.conv.weight' in t:
        p['ConvLSTMCell_0'] = {'Conv_0': {
            'kernel': np.ascontiguousarray(
                arr(t['lstm.conv.weight']).transpose(2, 3, 1, 0)),
            'bias': arr(t['lstm.conv.bias'])}}
    p['Dense_0'] = {'kernel': arr(t['policy_w'])}
    p['Dense_1'] = {'kernel': arr(t['value_w'])}
    out = {'params': p}
    if 'stem_mean' in t:
        rows = [(t['stem_mean'], t['stem_var'])] + [
            (t['block_mean'][i], t['block_var'][i])
            for i in range(t['block_mean'].shape[0])]
        out['batch_stats'] = {
            'TorusConv_%d' % i: {norm: {'mean': arr(m), 'var': arr(v)}}
            for i, (m, v) in enumerate(rows)}
    return out
