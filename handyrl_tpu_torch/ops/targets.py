"""Value and advantage targets: MC, TD(lambda), UPGO and V-Trace.

The port of ``handyrl_tpu/ops/targets.py`` (the plain recursions and
``compute_target``) and ``handyrl_tpu/ops/pallas_targets.py`` (the TPU
kernels ``_td_kernel``, ``_upgo_kernel`` and ``_vtrace_kernel``). Arrays are
batch-first ``(B, T, P, 1)`` as the batch builder emits them.

:func:`td_lambda`, :func:`upgo` and :func:`vtrace` are the plain versions:
a Python loop over reversed time. :func:`td_lambda_kernel`,
:func:`upgo_kernel` and :func:`vtrace_kernel` take the same arguments as
the JAX package's ``*_pallas`` wrappers and launch ``csrc/targets.cu`` for
a CUDA tensor; for a CPU tensor they run the plain version; any other
device raises. The kernels read the bootstrap row of ``returns`` in place
(through its strides, so a broadcast ``returns`` is never copied); the other
operands go to the kernel as they are when they are contiguous float32 of
the full shape, so such a target computation is one launch.
:func:`compute_target` dispatches on the device alone: there is no opt-in
and no fallback. Each kernel counts its launches through ``launches.count``
under its name (CPU calls never count).

Targets never carry gradients (the loss feeds them detached values), so no
backward exists.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_build, launches

Tensor = torch.Tensor


# ------------------------------------------------------------ plain versions

def _rewards_or_zeros(rewards: Optional[Tensor], values: Tensor) -> Tensor:
    return torch.zeros_like(values) if rewards is None else rewards


def monte_carlo(values: Tensor, returns: Tensor) -> Tuple[Tensor, Tensor]:
    return returns, returns - values


def _lambda_recursion(values, returns, rewards, lambda_, gamma, upgo_max):
    """tv_{T-1} = G; tv_t = r_t + g * boot_t with boot_t the lambda-mix of
    V_{t+1} and tv_{t+1} (UPGO: at least V_{t+1})."""
    rew = _rewards_or_zeros(rewards, values)
    T = values.shape[1]
    carry = returns[:, -1]
    out = [carry]
    for t in range(T - 2, -1, -1):
        v_next, lam = values[:, t + 1], lambda_[:, t + 1]
        mixed = (1 - lam) * v_next + lam * carry
        if upgo_max:
            mixed = torch.maximum(v_next, mixed)
        carry = rew[:, t] + gamma * mixed
        out.append(carry)
    tvs = torch.stack(out[::-1], dim=1)
    return tvs, tvs - values


def td_lambda(values: Tensor, returns: Tensor, rewards: Optional[Tensor],
              lambda_: Tensor, gamma: float) -> Tuple[Tensor, Tensor]:
    """TD(lambda): tv_t = r_t + g*((1-l_{t+1})*V_{t+1} + l_{t+1}*tv_{t+1}),
    bootstrapped from the returns at the final step."""
    return _lambda_recursion(values, returns, rewards, lambda_, gamma, False)


def upgo(values: Tensor, returns: Tensor, rewards: Optional[Tensor],
         lambda_: Tensor, gamma: float) -> Tuple[Tensor, Tensor]:
    """UPGO: TD(lambda) bootstrapped with max(V_{t+1}, the lambda mix)."""
    return _lambda_recursion(values, returns, rewards, lambda_, gamma, True)


def vtrace(values: Tensor, returns: Tensor, rewards: Optional[Tensor],
           lambda_: Tensor, gamma: float, rhos: Tensor, cs: Tensor
           ) -> Tuple[Tensor, Tensor]:
    """V-Trace (Espeholt et al. 2018): vs_t = V_t + the c-weighted sum of
    rho-corrected TD errors; the advantage is taken against vs_{t+1}."""
    rew = _rewards_or_zeros(rewards, values)
    T = values.shape[1]
    v_next = torch.cat([values[:, 1:], returns[:, -1:]], dim=1)
    deltas = rhos * (rew + gamma * v_next - values)
    carry = deltas[:, -1]
    out = [carry]
    for t in range(T - 2, -1, -1):
        carry = deltas[:, t] + gamma * (lambda_[:, t + 1] * cs[:, t]) * carry
        out.append(carry)
    vs = torch.stack(out[::-1], dim=1) + values
    vs_next = torch.cat([vs[:, 1:], returns[:, -1:]], dim=1)
    return vs, rew + gamma * vs_next - values


# --------------------------------------------------------------- the kernels

_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load('targets')
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        strides = [ctypes.c_longlong] * 2
        lib.targets_lambda.argtypes = [p] * 2 + strides + [p] * 4 + [i] * 4 + [
            f, p]
        lib.targets_lambda.restype = i
        lib.targets_vtrace.argtypes = [p] * 2 + strides + [p] * 6 + [i] * 3 + [
            f, p]
        lib.targets_vtrace.restype = i
        lib.targets_error_string.argtypes = [i]
        lib.targets_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _checked(name: str, t, device) -> Tensor:
    """``t`` itself, once it is a float32 tensor on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError('targets: %s must be a tensor' % name)
    if t.device != device:
        raise ValueError('targets: %s is on %s, values on %s'
                         % (name, t.device, device))
    if t.dtype != torch.float32:
        raise TypeError('targets: %s is %s; the kernel takes float32'
                        % (name, t.dtype))
    return t


def _operand(name: str, t: Optional[Tensor], shape, device) -> Optional[Tensor]:
    """``t`` broadcast to ``shape`` as a contiguous float32 tensor on
    ``device`` (a no-op when it already is one); None stays None."""
    if t is None:
        return None
    return _checked(name, t, device).expand(shape).contiguous()


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _bootstrap_row(returns, B: int, P: int, device) -> Tensor:
    """The returns' last row as a (B, 1, P, 1) view, broadcast with stride
    0 where ``returns`` has size 1: the kernel reads it in place through
    its strides, so nothing is copied."""
    if _checked('returns', returns, device).dim() != 4:
        raise ValueError('targets: returns must be (B, T_r, P, 1), got %s'
                         % (tuple(returns.shape),))
    return returns[:, -1:].expand(B, 1, P, 1)


def _launch(kind: str, values, returns, rewards, lambda_, gamma,
            rhos=None, cs=None) -> Tuple[Tensor, Tensor]:
    if values.dim() != 4 or values.shape[3] != 1:
        raise ValueError('targets: values must be (B, T, P, 1), got %s'
                         % (tuple(values.shape),))
    B, T, P, _ = values.shape
    dev = values.device
    shape = (B, T, P, 1)
    v = _operand('values', values, shape, dev)
    g = _bootstrap_row(returns, B, P, dev)
    g_strides = (g.stride(0), g.stride(2))
    rew = _operand('rewards', rewards, shape, dev)
    lam = _operand('lambda_', lambda_, shape, dev)
    target = torch.empty(shape, device=dev, dtype=torch.float32)
    adv = torch.empty(shape, device=dev, dtype=torch.float32)
    if target.numel() == 0:
        return target, adv
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == 'vtrace':
            rho = _operand('rhos', rhos, shape, dev)
            c = _operand('cs', cs, shape, dev)
            err = lib.targets_vtrace(
                _ptr(v), _ptr(g), *g_strides, _ptr(rew), _ptr(lam),
                _ptr(rho), _ptr(c), _ptr(target), _ptr(adv), B, T, P,
                float(gamma), stream)
        else:
            err = lib.targets_lambda(
                _ptr(v), _ptr(g), *g_strides, _ptr(rew), _ptr(lam),
                _ptr(target), _ptr(adv), B, T, P, int(kind == 'upgo'),
                float(gamma), stream)
    if err != 0:
        # a launch the kernel refuses (P > 128, or one row of a long T
        # beyond a block's shared memory) returns cudaErrorInvalidValue
        raise RuntimeError('targets: %s launch at (B, T, P) = %s failed with '
                           'CUDA error %d (%s)' % (
                               kind, (B, T, P), err,
                               lib.targets_error_string(err).decode()))
    launches.count(kind)
    return target, adv


def _device_kind(values: Tensor) -> str:
    kind = values.device.type
    if kind not in ('cpu', 'cuda'):
        raise ValueError('targets: no kernel for device %s' % values.device)
    return kind


def td_lambda_kernel(values, returns, rewards, lambda_, gamma):
    """K3, the port of ``pallas_targets.td_lambda_pallas``."""
    if _device_kind(values) == 'cpu':
        return td_lambda(values, returns, rewards, lambda_, gamma)
    return _launch('td_lambda', values, returns, rewards, lambda_, gamma)


def upgo_kernel(values, returns, rewards, lambda_, gamma):
    """K4, the port of ``pallas_targets.upgo_pallas``."""
    if _device_kind(values) == 'cpu':
        return upgo(values, returns, rewards, lambda_, gamma)
    return _launch('upgo', values, returns, rewards, lambda_, gamma)


def vtrace_kernel(values, returns, rewards, lambda_, gamma, rhos, cs):
    """K5, the port of ``pallas_targets.vtrace_pallas``: deltas, the
    recursion, vs and the advantages in one launch."""
    if _device_kind(values) == 'cpu':
        return vtrace(values, returns, rewards, lambda_, gamma, rhos, cs)
    return _launch('vtrace', values, returns, rewards, lambda_, gamma,
                   rhos, cs)


# ----------------------------------------------------------------- dispatch

def compute_target(algorithm: str, values: Optional[Tensor], returns: Tensor,
                   rewards: Optional[Tensor], lmb: float, gamma: float,
                   rhos: Tensor, cs: Tensor, masks: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """Dispatch on the algorithm's name, with the no-baseline fallback and
    the lambda-mask collapse lambda_t = lmb + (1 - lmb) * (1 - mask_t)."""
    if values is None:
        return returns, returns
    if algorithm == 'MC':
        return monte_carlo(values, returns)
    lambda_ = lmb + (1 - lmb) * (1 - masks)
    if algorithm == 'TD':
        return td_lambda_kernel(values, returns, rewards, lambda_, gamma)
    if algorithm == 'UPGO':
        return upgo_kernel(values, returns, rewards, lambda_, gamma)
    if algorithm == 'VTRACE':
        return vtrace_kernel(values, returns, rewards, lambda_, gamma, rhos, cs)
    raise ValueError('unknown target algorithm: %s' % algorithm)
