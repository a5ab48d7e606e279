"""The GeeseNet trunk forward: one CUDA kernel, and its plain PyTorch version.

The trunk is a 3x3 torus-conv stem with GroupNorm and ReLU, then L blocks of
``relu(h + GN(conv(h)))`` on the 7x11 board, (N,7,11,Cin) -> (N,7,11,F).
:func:`trunk_forward` is the wrapper the model calls. For a tensor on the
CPU it runs :func:`trunk_forward_reference`; for a CUDA tensor it launches
``csrc/geese_trunk.cu`` (the port of the TPU kernel
``handyrl_tpu/ops/pallas_geese.py:_fwd_kernel``) or raises. ``launches``
counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from . import cuda_build

ROWS, COLS = 7, 11
EPS = 1e-6
SUPPORTED_FILTERS = (16, 32)   # the kernel's instantiations

# kernel launches in this process (CPU calls never count)
launches = 0


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


def _group_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                groups: int, eps: float = EPS) -> torch.Tensor:
    """flax nn.GroupNorm: per-sample statistics over the board and the
    channels of each group, in fp32, var = E[x^2] - E[x]^2."""
    B, H, W, C = h.shape
    hf = h.float().reshape(B, H * W, groups, C // groups)
    n = float(H * W * (C // groups))
    mean = hf.sum(dim=(1, 3)) / n
    var = torch.clamp((hf * hf).sum(dim=(1, 3)) / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    hn = (hf - mean[:, None, :, None]) * rstd[:, None, :, None]
    return (hn.reshape(h.shape) * scale + bias).to(h.dtype)


def trunk_forward_reference(x, stem_w, stem_scale, stem_bias, block_w,
                            block_scale, block_bias, groups: int = 8,
                            eps: float = EPS) -> torch.Tensor:
    """Plain PyTorch twin of ``pallas_geese.tile_forward``, step by step:
    relu(GN(conv(x))) stem, then L x relu(h + GN(conv(h)))."""
    h = torch.relu(_group_norm(_torus_conv(x, stem_w), stem_scale, stem_bias,
                               groups, eps))
    for i in range(block_w.shape[0]):
        c = _group_norm(_torus_conv(h, block_w[i]), block_scale[i],
                        block_bias[i], groups, eps)
        h = torch.relu(h + c)
    return h


# ---------------------------------------------------------------- the kernel

_LIB = None


def _library() -> ctypes.CDLL:
    """The kernel library with every function's argtypes and restype
    declared (built and loaded on first use)."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load('geese_trunk')
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.geese_trunk_forward.argtypes = [p] * 8 + [i] * 5 + [
            ctypes.c_float, p]
        lib.geese_trunk_forward.restype = ctypes.c_int
        lib.geese_trunk_error_string.argtypes = [i]
        lib.geese_trunk_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           device: torch.device):
    if not isinstance(t, torch.Tensor):
        raise TypeError('geese_trunk: %s must be a tensor' % name)
    if t.device != device:
        raise ValueError('geese_trunk: %s is on %s, x on %s'
                         % (name, t.device, device))
    if t.dtype != torch.float32:
        raise TypeError('geese_trunk: %s is %s; the kernel takes float32'
                        % (name, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError('geese_trunk: %s has shape %s, expected %s'
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError('geese_trunk: %s must be contiguous' % name)
    if name != 'x' and t.data_ptr() % 16:
        # the kernel reads weights, scales and biases 16 bytes at a time
        raise ValueError('geese_trunk: %s must be 16-byte aligned' % name)


def trunk_forward(x, stem_w, stem_scale, stem_bias, block_w, block_scale,
                  block_bias, groups: int = 8,
                  eps: float = EPS) -> torch.Tensor:
    """The trunk, (N,7,11,Cin) -> (N,7,11,F). CPU tensors take the plain
    version; CUDA tensors launch the kernel, and anything the kernel does
    not take (dtype, shape, layout, F) raises."""
    global launches
    if x.device.type == 'cpu':
        return trunk_forward_reference(x, stem_w, stem_scale, stem_bias,
                                       block_w, block_scale, block_bias,
                                       groups, eps)
    if x.device.type != 'cuda':
        raise ValueError('geese_trunk: no kernel for device %s' % x.device)
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
    _check('x', x, (n, ROWS, COLS, cin), dev)
    _check('stem_w', stem_w, (3, 3, cin, filters), dev)
    _check('stem_scale', stem_scale, (filters,), dev)
    _check('stem_bias', stem_bias, (filters,), dev)
    _check('block_w', block_w, (layers, 3, 3, filters, filters), dev)
    _check('block_scale', block_scale, (layers, filters), dev)
    _check('block_bias', block_bias, (layers, filters), dev)
    out = torch.empty((n, ROWS, COLS, filters), device=dev,
                      dtype=torch.float32)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.geese_trunk_forward(
            x.data_ptr(), stem_w.data_ptr(), stem_scale.data_ptr(),
            stem_bias.data_ptr(), block_w.data_ptr(), block_scale.data_ptr(),
            block_bias.data_ptr(), out.data_ptr(), n, cin, filters, layers,
            groups, float(eps), stream)
    if err != 0:
        raise RuntimeError('geese_trunk: launch failed with CUDA error %d (%s)'
                           % (err, lib.geese_trunk_error_string(err).decode()))
    launches += 1
    return out


# ------------------------------------------------- flax param extraction

def trunk_params_from_geesenet(params: Dict, layers: int = 12
                               ) -> Tuple[np.ndarray, ...]:
    """Stack the GeeseNet trunk's flax params (``TorusConv_i/{Conv_0/kernel,
    GroupNorm_0/{scale,bias}}``, with or without the top-level 'params'
    key) into the kernel's operands: stem_w (3,3,Cin,F), stem_scale (F,),
    stem_bias (F,), block_w (L,3,3,F,F), block_scale (L,F), block_bias
    (L,F), as numpy arrays."""
    p = params['params'] if 'params' in params else params
    stem = p['TorusConv_0']
    blocks = [p['TorusConv_%d' % i] for i in range(1, layers + 1)]

    def stack(get):
        return np.stack([np.asarray(get(b)) for b in blocks])

    return (np.asarray(stem['Conv_0']['kernel']),
            np.asarray(stem['GroupNorm_0']['scale']),
            np.asarray(stem['GroupNorm_0']['bias']),
            stack(lambda b: b['Conv_0']['kernel']),
            stack(lambda b: b['GroupNorm_0']['scale']),
            stack(lambda b: b['GroupNorm_0']['bias']))
