"""The GeeseNet trunk, forward and backward: two CUDA kernels, each beside
its plain PyTorch version.

The trunk is a 3x3 torus-conv stem with GroupNorm and ReLU, then L blocks of
``relu(h + GN(conv(h)))`` on the 7x11 board, (N,7,11,Cin) -> (N,7,11,F).
:func:`trunk_forward` (K1, the port of the TPU kernel
``handyrl_tpu/ops/pallas_geese.py:_fwd_kernel``) and :func:`trunk_backward`
(K2, the port of ``_bwd_kernel``) are the wrappers: for a tensor on the CPU
they run :func:`trunk_forward_reference` and the hand-derived
:func:`trunk_backward_reference`; for a CUDA tensor they launch
``csrc/geese_trunk.cu`` or raise. :class:`TrunkFunction` ties the two into
autograd. The training forward saves, for K2, each block's input
(``acts``), each layer's normalised conv output (``xhat``) and per-group
rstd (``rstd``); with the output ``y`` they are all K2 reads of the
forward, so it recomputes no conv. Each kernel launch is counted by
``launches.count`` (as 'geese_trunk' and 'geese_trunk_bwd'; CPU calls never
count). K1's serving form is also the registered operator
``handyrl_tpu_torch::geese_trunk`` (:func:`trunk_serve`), which the net
calls without autograd and ``torch.export`` keeps as one node.

The dtype of x picks the form. float32 is the fp32 form. bfloat16 is the
bf16 form, the TPU kernel's ``dtype=bfloat16`` (``tile_forward``: the
weights cast to bf16, fp32 tap sums and GroupNorm statistics, the conv
output, the norm's output and the residual sum rounded to bf16); its
launches count as 'geese_trunk_bf16' and 'geese_trunk_bwd_bf16'. The
weights, scales and biases are float32 in both forms (the net's params);
in the bf16 form the output, the saved block inputs, dy and dx are bf16,
``xhat``, ``rstd`` and every weight grad float32. The bf16 backward rounds
to bf16 what the forward's bf16 tensors receive: each conv output's grad,
each transposed conv and its sum with the residual grad, and dx; its
weight grads are fp32 sums of bf16 products.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from . import cuda_build, launches

ROWS, COLS = 7, 11
EPS = 1e-6
SUPPORTED_FILTERS = (16, 32)   # the kernel's instantiations
# the activations' dtype of each of the kernel's two forms, and its
# launch counters (forward, backward)
COUNTERS = {torch.float32: ('geese_trunk', 'geese_trunk_bwd'),
            torch.bfloat16: ('geese_trunk_bf16', 'geese_trunk_bwd_bf16')}


# ------------------------------------------------------------ plain version

def _torus_conv(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 torus conv, h (B,7,11,C), w (3,3,C,F): wrap-pad with cat, then
    nine tap products (B*77, C) x (C, F) summed in fp32."""
    B, _, _, C = h.shape
    F = w.shape[-1]
    hp = torch.cat([h[:, -1:], h, h[:, :1]], dim=1)
    hp = torch.cat([hp[:, :, -1:], hp, hp[:, :, :1]], dim=2)
    acc = None
    for a in range(3):
        for b in range(3):
            patch = hp[:, a:a + ROWS, b:b + COLS].reshape(B * ROWS * COLS, C)
            t = torch.matmul(patch.float(), w[a, b].float())
            acc = t if acc is None else acc + t
    return acc.reshape(B, ROWS, COLS, F).to(h.dtype)


def _normalize(c: torch.Tensor, groups: int, eps: float = EPS):
    """flax nn.GroupNorm's statistics of c (B,H,W,C): per sample over the
    board and the channels of each group, in fp32, var = max(E[c^2] -
    E[c]^2, 0). Returns (xhat (B,H,W,C), rstd (B,groups), the unclamped
    variance (B,groups)), xhat = (c - mean) rstd."""
    B, H, W, C = c.shape
    cf = c.float().reshape(B, H * W, groups, C // groups)
    n = float(H * W * (C // groups))
    mean = cf.sum(dim=(1, 3)) / n
    var_raw = (cf * cf).sum(dim=(1, 3)) / n - mean * mean
    rstd = torch.rsqrt(torch.clamp(var_raw, min=0.0) + eps)
    xhat = (cf - mean[:, None, :, None]) * rstd[:, None, :, None]
    return xhat.reshape(c.shape), rstd, var_raw


def _group_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                groups: int, eps: float = EPS, saved=None) -> torch.Tensor:
    """flax nn.GroupNorm: xhat * scale + bias (:func:`_normalize`). With
    ``saved`` = (xhat (B,H,W,C), rstd (B,groups)) buffers, the values it
    normalises with are also written there."""
    xhat, rstd, _ = _normalize(h, groups, eps)
    if saved is not None:
        saved[0].copy_(xhat)
        saved[1].copy_(rstd)
    return (xhat * scale + bias).to(h.dtype)


def trunk_forward_reference(x, stem_w, stem_scale, stem_bias, block_w,
                            block_scale, block_bias, groups: int = 8,
                            eps: float = EPS, acts=None, xhat=None,
                            rstd=None) -> torch.Tensor:
    """Plain PyTorch twin of ``pallas_geese.tile_forward``, step by step:
    relu(GN(conv(x))) stem, then L x relu(h + GN(conv(h))), in x's dtype
    (the weights cast to it; float32 sums and statistics). The training
    forward's buffers, each optional: ``acts`` (N,L,7,11,F) gets block i's
    input at ``acts[:, i]``; ``xhat`` (N,L+1,7,11,F) and ``rstd``
    (N,L+1,groups) get layer l's normalised conv output and per-group rstd
    at ``[:, l]`` (layer 0 is the stem)."""
    stem_w, block_w = stem_w.to(x.dtype), block_w.to(x.dtype)

    def norm(c, l, scale, bias):
        saved = None
        if xhat is not None and rstd is not None:
            saved = (xhat[:, l], rstd[:, l])
        return _group_norm(c, scale, bias, groups, eps, saved)

    h = torch.relu(norm(_torus_conv(x, stem_w), 0, stem_scale, stem_bias))
    for i in range(block_w.shape[0]):
        if acts is not None:
            acts[:, i] = h
        c = norm(_torus_conv(h, block_w[i]), i + 1, block_scale[i],
                 block_bias[i])
        h = torch.relu(h + c)
    return h


# ------------------------------------------- plain version of the backward

def _tap_shift(a: int, b: int) -> Tuple[int, int]:
    """torch.roll shifts that bring tap (a, b)'s neighbour to each pixel:
    roll(h, s)[r, c] = h[(r + a - 1) % 7, (c + b - 1) % 11]."""
    return 1 - a, 1 - b


def _conv_transpose(dc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`_torus_conv` in its input: each tap's product
    dc @ w[a, b]^T rolled back by the tap's shift (the flipped taps, with
    the same wrap). dc (N,7,11,F), w (3,3,C,F) -> (N,7,11,C)."""
    out = None
    for a in range(3):
        for b in range(3):
            sr, sc = _tap_shift(a, b)
            t = torch.roll(torch.matmul(dc, w[a, b].t()), (-sr, -sc), (1, 2))
            out = t if out is None else out + t
    return out


def _conv_weight_grad(h: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`_torus_conv` in its kernel: for each tap, the
    neighbour patches^T @ dc summed over the batch and the board.
    h (N,7,11,C), dc (N,7,11,F) -> (3,3,C,F)."""
    C, F = h.shape[-1], dc.shape[-1]
    d2 = dc.reshape(-1, F)
    taps = [torch.matmul(torch.roll(h, _tap_shift(a, b), (1, 2))
                         .reshape(-1, C).t(), d2)
            for a in range(3) for b in range(3)]
    return torch.stack(taps).reshape(3, 3, C, F)


def _group_norm_backward(dz, xhat, rstd, scale, groups: int, var_raw=None):
    """The adjoint of :func:`_group_norm` at the normalised conv output
    xhat (B,H,W,C) with per-group rstd (B,groups): returns (dc, dscale,
    dbias), dc = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) with
    dxhat = dz scale; no mean is needed. Given the unclamped variance
    ``var_raw``, the last term is cut where max(var_raw, 0) clamps, as its
    derivative is 0 there (the saved path, like K2, has no variance and
    keeps it)."""
    B, H, W, C = dz.shape
    cpg = C // groups
    n = float(H * W * cpg)
    xh = xhat.reshape(B, H * W, groups, cpg)
    gz = dz.reshape(B, H * W, groups, cpg)
    dscale = (gz * xh).sum(dim=(0, 1)).reshape(C)
    dbias = gz.sum(dim=(0, 1)).reshape(C)
    dxhat = gz * scale.reshape(groups, cpg)
    m1 = dxhat.sum(dim=(1, 3)) / n
    m2 = (dxhat * xh).sum(dim=(1, 3)) / n
    if var_raw is not None:
        m2 = m2 * (var_raw > 0)
    dc = rstd[:, None, :, None] * (dxhat - m1[:, None, :, None]
                                   - xh * m2[:, None, :, None])
    return dc.reshape(dz.shape), dscale, dbias


def trunk_backward_reference(x, stem_w, stem_scale, stem_bias, block_w,
                             block_scale, block_bias, dy, groups: int = 8,
                             eps: float = EPS, need_dx: bool = True,
                             acts=None, y=None, xhat=None, rstd=None):
    """The trunk's backward derived by hand, in plain PyTorch: from the top
    layer down the ReLU mask, the GroupNorm backward, the weight grad and
    the transposed conv, with the residual's identity path on every block
    and none on the stem. The layer inputs and outputs are ``acts`` and
    ``y``, the block inputs and the output of a training forward (as K2
    takes them), so that the ReLU masks are that forward's own; without
    them the plain training forward runs here first. Each layer's
    normalised conv output and rstd are ``xhat`` and ``rstd`` from that
    forward (as K2 reads them); without them they are recomputed from the
    layer inputs. Returns (dx or None, d_stem_w, d_stem_scale,
    d_stem_bias, d_block_w, d_block_scale, d_block_bias): dx in x's
    dtype, the rest float32. With x in bf16 the math runs in float32 on
    the bf16 values, the weights rounded to bf16, and rounds to bf16 each
    conv output's grad, each transposed conv, its sum with the residual
    grad and dx, as the bf16 kernel does."""
    layers = [(stem_w, stem_scale, stem_bias)] + [
        (block_w[i], block_scale[i], block_bias[i])
        for i in range(block_w.shape[0])]
    if acts is None or y is None:
        acts = x.new_empty((x.shape[0], block_w.shape[0], ROWS, COLS,
                            stem_w.shape[-1]))
        y = trunk_forward_reference(x, stem_w, stem_scale, stem_bias,
                                    block_w, block_scale, block_bias, groups,
                                    eps, acts)
    blocks_in = [acts[:, i] for i in range(acts.shape[1])]
    inputs, outs = [x] + blocks_in, blocks_in + [y]
    if xhat is None or rstd is None:
        normed = [_normalize(_torus_conv(h, w.to(x.dtype)), groups, eps)
                  for h, (w, _, _) in zip(inputs, layers)]
    else:
        normed = [(xhat[:, l], rstd[:, l], None) for l in range(len(layers))]
    if x.dtype == torch.float32:
        def rd(t):
            return t
    else:   # the bf16 form's rounding points
        def rd(t):
            return t.to(x.dtype).float()
    dh = dy.float()
    grads = [None] * len(layers)
    dx = None
    for i in range(len(layers) - 1, -1, -1):
        w, s, _ = layers[i]
        w = rd(w)
        g = dh * (outs[i] > 0)
        dc, ds, db = _group_norm_backward(g, *normed[i][:2], s, groups,
                                          normed[i][2])
        dc = rd(dc)
        grads[i] = (_conv_weight_grad(inputs[i].float(), dc), ds, db)
        if i > 0:
            dh = rd(g + rd(_conv_transpose(dc, w)))
        elif need_dx:
            dx = _conv_transpose(dc, w).to(x.dtype)
    blocks = grads[1:]

    def stack(k, like):
        return (torch.stack([g[k] for g in blocks]) if blocks
                else torch.zeros_like(like))

    return (dx,) + grads[0] + (stack(0, block_w), stack(1, block_scale),
                               stack(2, block_bias))


# ---------------------------------------------------------------- the kernel

_LIB = None


def _library() -> ctypes.CDLL:
    """The kernel library with every function's argtypes and restype
    declared (built and loaded on first use)."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load('geese_trunk')
        p, i = ctypes.c_void_p, ctypes.c_int
        for suffix in ('', '_bf16'):
            fwd = getattr(lib, 'geese_trunk_forward' + suffix)
            fwd.argtypes = [p] * 11 + [i] * 5 + [ctypes.c_float, p]
            fwd.restype = ctypes.c_int
            bwd = getattr(lib, 'geese_trunk_backward' + suffix)
            bwd.argtypes = [p] * 15 + [i] * 5 + [p]
            bwd.restype = ctypes.c_int
        lib.geese_trunk_backward_chunk.argtypes = []
        lib.geese_trunk_backward_chunk.restype = ctypes.c_int
        lib.geese_trunk_error_string.argtypes = [i]
        lib.geese_trunk_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           device: torch.device, dtype: torch.dtype = torch.float32):
    if not isinstance(t, torch.Tensor):
        raise TypeError('geese_trunk: %s must be a tensor' % name)
    if t.device != device:
        raise ValueError('geese_trunk: %s is on %s, x on %s'
                         % (name, t.device, device))
    if t.dtype != dtype:
        raise TypeError('geese_trunk: %s is %s; the kernel takes %s here'
                        % (name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError('geese_trunk: %s has shape %s, expected %s'
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError('geese_trunk: %s must be contiguous' % name)
    if name != 'x' and t.data_ptr() % 16:
        # the kernel reads weights, scales and biases 16 bytes at a time
        raise ValueError('geese_trunk: %s must be 16-byte aligned' % name)


def _check_operands(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                    block_bias, groups: int) -> Tuple[int, int, int, int]:
    """Raise on anything the kernels do not take; returns (n, cin, F, L)."""
    if x.dim() != 4 or tuple(x.shape[1:3]) != (ROWS, COLS):
        raise ValueError('geese_trunk: x must be (N,7,11,Cin), got %s'
                         % (tuple(x.shape),))
    n, cin = x.shape[0], x.shape[3]
    filters, layers = stem_w.shape[-1], block_w.shape[0]
    if filters not in SUPPORTED_FILTERS:
        raise ValueError('geese_trunk: the kernel is built for F in %s, got '
                         '%d' % (SUPPORTED_FILTERS, filters))
    if groups <= 0 or filters % groups:
        raise ValueError('geese_trunk: %d groups do not divide F=%d'
                         % (groups, filters))
    dev = x.device
    if x.dtype not in COUNTERS:
        raise TypeError('geese_trunk: x is %s; the kernel takes float32 or '
                        'bfloat16' % (x.dtype,))
    _check('x', x, (n, ROWS, COLS, cin), dev, x.dtype)
    _check('stem_w', stem_w, (3, 3, cin, filters), dev)
    _check('stem_scale', stem_scale, (filters,), dev)
    _check('stem_bias', stem_bias, (filters,), dev)
    _check('block_w', block_w, (layers, 3, 3, filters, filters), dev)
    _check('block_scale', block_scale, (layers, filters), dev)
    _check('block_bias', block_bias, (layers, filters), dev)
    return n, cin, filters, layers


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError('geese_trunk: no kernel for device %s' % x.device)
    return x.device.type


def _raise_on(err: int, lib, what: str):
    if err != 0:
        raise RuntimeError('geese_trunk: %s launch failed with CUDA error %d '
                           '(%s)' % (what, err,
                                     lib.geese_trunk_error_string(err).decode()))


def training_buffers(n: int, layers: int, filters: int, groups: int,
                     device, dtype: torch.dtype = torch.float32
                     ) -> Dict[str, torch.Tensor]:
    """Empty buffers for what the training forward saves for K2: ``acts``
    (n,L,7,11,F) in the activations' ``dtype``, float32 ``xhat``
    (n,L+1,7,11,F) and ``rstd`` (n,L+1,groups), to pass to
    :func:`trunk_forward` as keywords."""
    f32 = dict(device=device, dtype=torch.float32)
    return {'acts': torch.empty((n, layers, ROWS, COLS, filters),
                                device=device, dtype=dtype),
            'xhat': torch.empty((n, layers + 1, ROWS, COLS, filters), **f32),
            'rstd': torch.empty((n, layers + 1, groups), **f32)}


def _check_saved(n, layers, filters, groups, dev, dtype, acts=None,
                 xhat=None, rstd=None, y=None):
    """Shape and dtype checks of the training forward's saved tensors
    (``dtype``: the activations')."""
    _check('acts', acts, (n, layers, ROWS, COLS, filters), dev, dtype)
    _check('xhat', xhat, (n, layers + 1, ROWS, COLS, filters), dev)
    _check('rstd', rstd, (n, layers + 1, groups), dev)
    if y is not None:
        _check('y', y, (n, ROWS, COLS, filters), dev, dtype)


def trunk_forward(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                  block_bias, groups: int = 8, eps: float = EPS,
                  acts=None, xhat=None, rstd=None) -> torch.Tensor:
    """The trunk, (N,7,11,Cin) -> (N,7,11,F). CPU tensors take the plain
    version; CUDA tensors launch the kernel, and anything the kernel does
    not take (dtype, shape, layout, F) raises. x's dtype (float32 or
    bfloat16) picks the form; the output is in it. The training forward,
    which K2 reads, also writes ``acts`` (N,L,7,11,F; each block's input,
    in x's dtype), ``xhat`` (N,L+1,7,11,F; each layer's normalised conv
    output) and ``rstd`` (N,L+1,groups), both float32; the kernel takes
    the three together or none of them."""
    if _device_kind(x) == 'cpu':
        return trunk_forward_reference(x, stem_w, stem_scale, stem_bias,
                                       block_w, block_scale, block_bias,
                                       groups, eps, acts, xhat, rstd)
    return _launch_forward(x, stem_w, stem_scale, stem_bias, block_w,
                           block_scale, block_bias, groups, eps, acts, xhat,
                           rstd)


def _launch_forward(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                    block_bias, groups: int, eps: float, acts=None,
                    xhat=None, rstd=None) -> torch.Tensor:
    """K1 on a CUDA tensor: checks, launch, count; raises on anything the
    kernel does not take and on a failed build or launch."""
    n, cin, filters, layers = _check_operands(
        x, stem_w, stem_scale, stem_bias, block_w, block_scale, block_bias,
        groups)
    dev = x.device
    saved = (acts, xhat, rstd)
    training = acts is not None
    if any((t is None) == training for t in saved):
        raise ValueError('geese_trunk: the training forward takes acts, '
                         'xhat and rstd together')
    if training:
        _check_saved(n, layers, filters, groups, dev, x.dtype, *saved)
    out = torch.empty((n, ROWS, COLS, filters), device=dev, dtype=x.dtype)
    if n == 0:
        return out
    lib = _library()
    ptrs = [None if t is None else t.data_ptr() for t in saved]
    bf16 = x.dtype == torch.bfloat16
    fn = lib.geese_trunk_forward_bf16 if bf16 else lib.geese_trunk_forward
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            x.data_ptr(), stem_w.data_ptr(), stem_scale.data_ptr(),
            stem_bias.data_ptr(), block_w.data_ptr(), block_scale.data_ptr(),
            block_bias.data_ptr(), out.data_ptr(), *ptrs, n, cin, filters,
            layers, groups, float(eps), stream)
    _raise_on(err, lib, 'forward')
    launches.count(COUNTERS[x.dtype][0])
    return out


# K1's serving form as a registered operator, so that a program traced
# with torch.export holds the kernel as one node
# (``handyrl_tpu_torch::geese_trunk``) and runs it after a reload. The net
# calls it on its no-grad path (models/geese.py); the training form stays
# TrunkFunction. CPU tensors take the plain version, CUDA tensors launch K1.
# It is defined through torch.library.Library, whose kernels the dispatcher
# calls directly: torch.library.custom_op runs each call through an
# autograd function and a torch._dynamo guard, and that guard's import
# takes seconds at the first forward of every process.

_OPS = torch.library.Library('handyrl_tpu_torch', 'DEF')
_OPS.define('geese_trunk(Tensor x, Tensor stem_w, Tensor stem_scale, '
            'Tensor stem_bias, Tensor block_w, Tensor block_scale, '
            'Tensor block_bias, int groups, float eps) -> Tensor')


def _geese_trunk_fake(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                      block_bias, groups, eps):
    return x.new_empty((x.shape[0], ROWS, COLS, stem_w.shape[-1]))


_OPS.impl('geese_trunk', trunk_forward_reference, 'CPU')
_OPS.impl('geese_trunk', _launch_forward, 'CUDA')
torch.library.register_fake('handyrl_tpu_torch::geese_trunk',
                            _geese_trunk_fake, lib=_OPS)


def trunk_serve(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                block_bias, groups: int = 8, eps: float = EPS) -> torch.Tensor:
    """K1's serving form through the registered operator."""
    return torch.ops.handyrl_tpu_torch.geese_trunk(
        x, stem_w, stem_scale, stem_bias, block_w, block_scale, block_bias,
        int(groups), float(eps))


def trunk_backward(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                   block_bias, dy, groups: int = 8, eps: float = EPS,
                   need_dx: bool = True, acts=None, y=None, xhat=None,
                   rstd=None):
    """The trunk's vector-Jacobian product at (x, weights) for the output
    grad dy (N,7,11,F) in x's dtype: (dx or None, d_stem_w, d_stem_scale,
    d_stem_bias, d_block_w, d_block_scale, d_block_bias), dx in x's dtype
    and the rest float32. CPU tensors take
    :func:`trunk_backward_reference`; CUDA tensors launch K2 or raise.
    ``acts``, ``y``, ``xhat`` and ``rstd`` are what the training forward
    of the same operands saved (:func:`trunk_forward` with acts, xhat and
    rstd, and its output); the kernel needs all four, the plain version
    runs or recomputes what it is not given."""
    if _device_kind(x) == 'cpu':
        return trunk_backward_reference(x, stem_w, stem_scale, stem_bias,
                                        block_w, block_scale, block_bias, dy,
                                        groups, eps, need_dx, acts, y, xhat,
                                        rstd)
    n, cin, filters, layers = _check_operands(
        x, stem_w, stem_scale, stem_bias, block_w, block_scale, block_bias,
        groups)
    dev = x.device
    _check('dy', dy, (n, ROWS, COLS, filters), dev, x.dtype)
    if acts is None or y is None or xhat is None or rstd is None:
        raise ValueError('geese_trunk: the backward kernel takes acts, y, '
                         'xhat and rstd from the training forward '
                         '(trunk_forward(..., acts=, xhat=, rstd=))')
    _check_saved(n, layers, filters, groups, dev, x.dtype, acts, xhat, rstd,
                 y)
    nl = layers + 1
    n_stem, n_blocks = 9 * cin * filters, layers * 9 * filters * filters
    total = n_stem + n_blocks + 2 * nl * filters
    # the kernel writes every element; an empty batch has zero grads
    flat = (torch.empty if n else torch.zeros)(total, device=dev,
                                               dtype=torch.float32)
    dx = torch.empty_like(x) if need_dx else None
    if n > 0:
        lib = _library()
        chunks = -(-n // lib.geese_trunk_backward_chunk())
        f32 = dict(device=dev, dtype=torch.float32)
        dc_all = torch.empty((n, nl, ROWS * COLS, filters), device=dev,
                             dtype=x.dtype)
        dsn = torch.empty((n, nl, 2 * filters), **f32)
        partials = torch.empty((chunks, total), **f32)
        bf16 = x.dtype == torch.bfloat16
        fn = (lib.geese_trunk_backward_bf16 if bf16
              else lib.geese_trunk_backward)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(
                x.data_ptr(), stem_w.data_ptr(), stem_scale.data_ptr(),
                block_w.data_ptr(), block_scale.data_ptr(), acts.data_ptr(),
                y.data_ptr(), xhat.data_ptr(), rstd.data_ptr(),
                dy.data_ptr(), None if dx is None else dx.data_ptr(),
                dc_all.data_ptr(), dsn.data_ptr(), partials.data_ptr(),
                flat.data_ptr(), n, cin, filters, layers, groups, stream)
        _raise_on(err, lib, 'backward')
        launches.count(COUNTERS[x.dtype][1])
    elif dx is not None:
        dx.zero_()
    scales = flat[n_stem + n_blocks:].view(2, nl, filters)
    return (dx, flat[:n_stem].view(3, 3, cin, filters),
            scales[0, 0], scales[1, 0],
            flat[n_stem:n_stem + n_blocks].view(layers, 3, 3, filters,
                                                filters),
            scales[0, 1:], scales[1, 1:])


class TrunkFunction(torch.autograd.Function):
    """The trunk under autograd: the forward is K1's training form, which
    keeps each block's input, each layer's normalised conv output and
    rstd for the backward; the backward is K2 on those and the output. On
    the CPU both are their plain versions. ``dx`` is computed only when x
    needs a grad. The backward counts its launch under the forward's
    launch path: autograd runs a CUDA backward on its own thread."""

    @staticmethod
    def forward(ctx, x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                block_bias, groups, eps):
        saved = training_buffers(x.shape[0], block_w.shape[0],
                                 stem_w.shape[-1], groups, x.device, x.dtype)
        y = trunk_forward(x, stem_w, stem_scale, stem_bias, block_w,
                          block_scale, block_bias, groups, eps, **saved)
        ctx.save_for_backward(x, stem_w, stem_scale, stem_bias, block_w,
                              block_scale, block_bias, saved['acts'], y,
                              saved['xhat'], saved['rstd'])
        ctx.groups, ctx.eps = groups, eps
        ctx.launch_path = launches.current_path()
        return y

    @staticmethod
    def backward(ctx, dy):
        x, sw, ss, sb, bw, bs, bb, acts, y, xhat, rstd = ctx.saved_tensors
        with launches.path(ctx.launch_path):
            grads = trunk_backward(x, sw, ss, sb, bw, bs, bb, dy.contiguous(),
                                   ctx.groups, ctx.eps,
                                   need_dx=ctx.needs_input_grad[0],
                                   acts=acts, y=y, xhat=xhat, rstd=rstd)
        return grads + (None, None)


def trunk_apply(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                block_bias, groups: int = 8, eps: float = EPS) -> torch.Tensor:
    """The trunk through :class:`TrunkFunction` (differentiable)."""
    return TrunkFunction.apply(x, stem_w, stem_scale, stem_bias, block_w,
                               block_scale, block_bias, groups, eps)


# ------------------------------------------------- flax param extraction

def trunk_params_from_geesenet(params: Dict, layers: int = 12,
                               norm: str = 'GroupNorm_0'
                               ) -> Tuple[np.ndarray, ...]:
    """Stack the GeeseNet trunk's flax params (``TorusConv_i/{Conv_0/kernel,
    GroupNorm_0/{scale,bias}}``, with or without the top-level 'params'
    key; ``norm`` names another norm layer) into the kernel's operands:
    stem_w (3,3,Cin,F), stem_scale (F,), stem_bias (F,), block_w
    (L,3,3,F,F), block_scale (L,F), block_bias (L,F), as numpy arrays."""
    p = params['params'] if 'params' in params else params
    stem = p['TorusConv_0']
    blocks = [p['TorusConv_%d' % i] for i in range(1, layers + 1)]

    def stack(get):
        return np.stack([np.asarray(get(b)) for b in blocks])

    return (np.asarray(stem['Conv_0']['kernel']),
            np.asarray(stem[norm]['scale']),
            np.asarray(stem[norm]['bias']),
            stack(lambda b: b['Conv_0']['kernel']),
            stack(lambda b: b[norm]['scale']),
            stack(lambda b: b[norm]['bias']))
