"""The SGD update step.

The port of ``handyrl_tpu/ops/train_step.py:25-136``: forward, targets,
losses, gradients, global-norm clip at 4.0, additive weight decay 1e-5,
Adam, parameter update, with the learning rate a runtime 0-d tensor. The
state is functional, as in the JAX package: ``update(state, batch, lr)``
returns a new :class:`TrainState` and leaves the old one as it was, and the
net runs on the state's parameters through ``torch.func.functional_call``.

The optimizer is written out on tensors, because ``torch.optim.Adam`` and
``clip_grad_norm_`` compute other numbers than the optax chain
``clip_by_global_norm(4.0) -> add_decayed_weights(1e-5) -> scale_by_adam()``
(torch clips by ``max_norm / (norm + 1e-6)`` and keeps no separate decay
step), and because the non-finite guard has to keep the moments and the
step count of a bad step as well as the parameters. The guard decides on
the device, with no host sync.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.func import functional_call

from .losses import LossConfig, compute_loss

Tensor = torch.Tensor

CLIP_NORM = 4.0
WEIGHT_DECAY = 1e-5
B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState`` over the net's parameters by name."""
    count: Tensor            # int32 0-d
    mu: Dict[str, Tensor]
    nu: Dict[str, Tensor]


class TrainState(NamedTuple):
    params: Dict[str, Tensor]
    opt_state: AdamState
    steps: Tensor            # int32 0-d


def init_train_state(module: torch.nn.Module) -> TrainState:
    """The module's parameters (detached copies) with zero Adam moments."""
    params = {k: v.detach().clone() for k, v in module.named_parameters()}
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return TrainState(
        params=params,
        opt_state=AdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev), mu=zeros,
            nu={k: torch.zeros_like(v) for k, v in params.items()}),
        steps=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tensors) -> Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def build_update_step(module: torch.nn.Module, cfg: LossConfig
                      ) -> Callable[[TrainState, Dict[str, Any], Tensor],
                                    Tuple[TrainState, Dict[str, Tensor]]]:
    """Returns ``update(state, batch, lr) -> (state, metrics)``.

    ``metrics`` holds the per-term loss sums, the turn count of the batch
    (``data_count``), the ``diag_*`` off-policy diagnostics and
    ``diag_grad_norm`` (the norm before the clip), all 0-d tensors on the
    device; a step that met a non-finite lr, loss or gradient reports them
    as zeros and ``nonfinite`` 1, and keeps the parameters and the
    optimizer state, Adam's count included. ``steps`` advances either way.
    """
    def apply_fn(params, obs, hidden):
        return functional_call(module, params, (obs, hidden))

    def update(state: TrainState, batch: Dict[str, Any], lr: Tensor
               ) -> Tuple[TrainState, Dict[str, Tensor]]:
        names = list(state.params)
        live = {k: v.detach().requires_grad_(True)
                for k, v in state.params.items()}
        total, aux = compute_loss(apply_fn, live, None, batch, cfg)
        grads = dict(zip(names, torch.autograd.grad(
            total, [live[k] for k in names])))
        with torch.no_grad():
            grad_norm = global_norm(grads.values())
            ok = (torch.isfinite(lr) & torch.isfinite(total.detach())
                  & torch.isfinite(grad_norm))
            # clip_by_global_norm: g if norm < 4 else g / norm * 4
            trigger = grad_norm < CLIP_NORM
            opt = state.opt_state
            count = opt.count + 1          # int32, as optax's safe_increment
            bc1 = 1 - B1 ** count.float()
            bc2 = 1 - B2 ** count.float()
            params, mu, nu = {}, {}, {}
            for k in names:
                p, g = state.params[k], grads[k]
                g = torch.where(trigger, g, g / grad_norm * CLIP_NORM)
                g = g + WEIGHT_DECAY * p                 # add_decayed_weights
                m = (1 - B1) * g + B1 * opt.mu[k]        # scale_by_adam
                v = (1 - B2) * g ** 2 + B2 * opt.nu[k]
                u = (m / bc1) / (torch.sqrt(v / bc2 + EPS_ROOT) + EPS)
                params[k] = torch.where(ok, p + (-lr * u), p)
                mu[k] = torch.where(ok, m, opt.mu[k])
                nu[k] = torch.where(ok, v, opt.nu[k])
            new_opt = AdamState(count=torch.where(ok, count, opt.count),
                                mu=mu, nu=nu)
            metrics = {k: v.detach() for k, v in aux['losses'].items()}
            metrics['data_count'] = aux['data_count']
            for k, v in aux['diag'].items():
                metrics['diag_' + k] = v
            metrics['diag_grad_norm'] = grad_norm
            metrics = {k: torch.where(ok, v, torch.zeros_like(v))
                       for k, v in metrics.items()}
            metrics['nonfinite'] = 1.0 - ok.float()
        return (TrainState(params=params, opt_state=new_opt,
                           steps=state.steps + 1), metrics)

    return update


# --------------------------------------------- optax layout, in and out

def opt_state_to_flax(opt_state: AdamState, to_flax: Callable
                      ) -> Dict[str, Any]:
    """The Adam state in optax's layout, as numpy: ``{'count': int32,
    'mu': tree, 'nu': tree}`` with the moments as flax param trees
    (``to_flax`` is the net's ``params_to_flax``)."""
    return {'count': np.asarray(opt_state.count.cpu().numpy(), np.int32),
            'mu': to_flax(opt_state.mu), 'nu': to_flax(opt_state.nu)}


def opt_state_from_flax(count, mu_tree, nu_tree, from_flax: Callable,
                        device: Any = 'cpu') -> AdamState:
    """An :class:`AdamState` from optax's ``ScaleByAdamState`` fields
    (``from_flax`` is the net's ``params_from_flax``)."""
    def load(tree):
        return {k: v.to(device) for k, v in from_flax(tree).items()}
    return AdamState(
        count=torch.tensor(int(count), dtype=torch.int32, device=device),
        mu=load(mu_tree), nu=load(nu_tree))
