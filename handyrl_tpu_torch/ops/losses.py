"""Forward pass and loss composition for the update step.

The port of ``handyrl_tpu/ops/losses.py`` (itself the reference training
pipeline, train.py:127-267): the same masks, importance-sampling clipping,
two-player value symmetrization and terminal bootstrap. Feed-forward nets
fold (B, T, P) into one batch dimension and run the net once. Losses are
sums, not means, so the learning-rate schedule sees the true data count.

The targets go through ``ops/targets.py``, which launches the CUDA kernels
K3-K5 for tensors on the card.

Not ported yet (each raises ``NotImplementedError``): the recurrent scan
with hidden gating and burn-in replay, ``norm_kind='batch'`` running
statistics and the IMPACT target network (losses.py:257-296); ROADMAP.md
lists them under slice 2's subsets.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..utils.tree import map_structure
from .targets import compute_target

Tensor = torch.Tensor

_DEFERRED = 'is not ported yet (ROADMAP.md, slice 2\'s subsets)'


class LossConfig(NamedTuple):
    """The training configuration the step is built for."""
    turn_based_training: bool = True
    observation: bool = False
    burn_in_steps: int = 0
    policy_target: str = 'TD'
    value_target: str = 'TD'
    lmb: float = 0.7
    gamma: float = 0.8
    entropy_regularization: float = 0.1
    entropy_regularization_decay: float = 0.1
    # IMPACT-style clipped target network; 0 = off (the only mode ported)
    target_clip: float = 0.0


def _fold_bt(x: Tensor) -> Tensor:
    """(B, T, P, ...) -> (B*T*P, ...)"""
    return x.reshape((-1,) + tuple(x.shape[3:]))


def forward_prediction(apply_fn: Callable, params, hidden,
                       batch: Dict[str, Any], cfg: LossConfig,
                       batch_stats=None) -> Dict[str, Tensor]:
    """Run the net over a training window: ``apply_fn(params, obs,
    hidden)`` on the (B*T*P_obs)-folded observations. Returns outputs
    shaped (B, T, P, ...) with the policy turn-gathered and masked by the
    legal actions, and every other output masked by observation_mask."""
    if hidden is not None:
        raise NotImplementedError('the recurrent loss path ' + _DEFERRED)
    if batch_stats is not None:
        raise NotImplementedError("norm_kind='batch' training " + _DEFERRED)
    B, T, P_obs = batch['action'].shape[:3]
    obs = map_structure(_fold_bt, batch['observation'])
    outputs = {k: v.reshape((B, T, P_obs) + tuple(v.shape[1:]))
               for k, v in dict(apply_fn(params, obs, None)).items()
               if k != 'hidden' and v is not None}
    masked = {}
    for k, o in outputs.items():
        if k == 'policy':
            o = o * batch['turn_mask']
            if o.shape[2] > 1 and P_obs == 1:
                # turn-alternating batch: gather the acting player's row
                o = o.sum(dim=2, keepdim=True)
            masked[k] = o - batch['action_mask']
        else:
            masked[k] = o * batch['observation_mask']
    return masked


def _entropy(logits: Tensor) -> Tensor:
    """Categorical entropy over the last axis; -1e32-masked logits add
    exactly zero (their probability underflows to 0, the logit is finite)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -(torch.exp(logp) * logp).sum(dim=-1)


def optax_huber(pred: Tensor, target: Tensor, delta: float = 1.0) -> Tensor:
    """Smooth-L1 (huber, delta=1), elementwise, as optax computes it."""
    abs_err = (pred - target).abs()
    quad = torch.clamp(abs_err, max=delta)
    return 0.5 * quad ** 2 + delta * (abs_err - quad)


def compose_losses(outputs: Dict[str, Tensor], log_selected_policies: Tensor,
                   total_advantages: Tensor,
                   targets: Dict[str, Optional[Tensor]],
                   batch: Dict[str, Any], cfg: LossConfig
                   ) -> Tuple[Dict[str, Tensor], Tensor]:
    tmasks = batch['turn_mask']
    omasks = batch['observation_mask']
    losses: Dict[str, Tensor] = {}
    dcnt = tmasks.sum()

    losses['p'] = (-log_selected_policies * total_advantages * tmasks).sum()
    if 'value' in outputs:
        losses['v'] = (((outputs['value'] - targets['value']) ** 2)
                       * omasks).sum() / 2
    if 'return' in outputs:
        losses['r'] = (optax_huber(outputs['return'], targets['return'])
                       * omasks).sum()

    entropy = _entropy(outputs['policy']) * tmasks.sum(dim=-1)
    losses['ent'] = entropy.sum()

    base = losses['p'] + losses.get('v', 0) + losses.get('r', 0)
    decay = 1 - batch['progress'] * (1 - cfg.entropy_regularization_decay)
    entropy_loss = (entropy * decay).sum() * -cfg.entropy_regularization
    losses['total'] = base + entropy_loss
    return losses, dcnt


def compute_loss(apply_fn: Callable, params, init_hidden,
                 batch: Dict[str, Any], cfg: LossConfig, batch_stats=None,
                 target_params=None) -> Tuple[Tensor, Dict[str, Any]]:
    """Forward, targets, advantages, composed losses. Returns (total loss,
    aux) where aux carries the per-term sums ('losses'), the data count
    ('data_count') and the off-policy diagnostics ('diag')."""
    if target_params is not None and cfg.target_clip > 0:
        raise NotImplementedError('the IMPACT target network ' + _DEFERRED)
    if cfg.burn_in_steps > 0:
        raise NotImplementedError('burn-in (the recurrent loss path) '
                                  + _DEFERRED)
    outputs = forward_prediction(apply_fn, params, init_hidden, batch, cfg,
                                 batch_stats)

    actions = batch['action'].long()
    emasks = batch['episode_mask']
    omasks = batch['observation_mask']
    value_target_masks = omasks
    clip_rho, clip_c = 1.0, 1.0

    log_b = torch.log(torch.clamp(batch['selected_prob'], 1e-16, 1)) * emasks
    logp = torch.log_softmax(outputs['policy'], dim=-1)
    log_t = torch.gather(logp, -1, actions) * emasks

    rhos = torch.exp(log_t.detach() - log_b)
    clipped_rhos = torch.clamp(rhos, 0, clip_rho)
    cs = torch.clamp(rhos, 0, clip_c)
    outputs_nograd = {k: v.detach() for k, v in outputs.items()}

    if 'value' in outputs_nograd:
        values_nograd = outputs_nograd['value']
        if cfg.turn_based_training and values_nograd.shape[2] == 2:
            # two-player zero-sum: each player's estimate is blended with
            # the negation of the opponent's (train.py:243-247)
            values_opp = -torch.flip(values_nograd, dims=(2,))
            omasks_opp = torch.flip(omasks, dims=(2,))
            values_nograd = ((values_nograd * omasks + values_opp * omasks_opp)
                             / (omasks + omasks_opp + 1e-8))
            value_target_masks = torch.clamp(omasks + omasks_opp, 0, 1)
        # bootstrap padded steps beyond episode end with the final outcome
        outputs_nograd['value'] = (values_nograd * emasks
                                   + batch['outcome'] * (1 - emasks))

    targets: Dict[str, Any] = {}
    advantages: Dict[str, Any] = {}
    value_args = (outputs_nograd.get('value'), batch['outcome'], None,
                  cfg.lmb, 1.0, clipped_rhos, cs, value_target_masks)
    return_args = (outputs_nograd.get('return'), batch['return'],
                   batch['reward'], cfg.lmb, cfg.gamma, clipped_rhos, cs,
                   omasks)
    targets['value'], advantages['value'] = compute_target(
        cfg.value_target, *value_args)
    targets['return'], advantages['return'] = compute_target(
        cfg.value_target, *return_args)
    if cfg.policy_target != cfg.value_target:
        _, advantages['value'] = compute_target(cfg.policy_target,
                                                *value_args)
        _, advantages['return'] = compute_target(cfg.policy_target,
                                                 *return_args)

    # without a return head, the return target is batch['return'] itself
    # (the no-baseline fallback), as in the reference
    total_advantages = clipped_rhos * (advantages['value']
                                       + advantages['return'])

    losses, dcnt = compose_losses(outputs, log_t, total_advantages, targets,
                                  batch, cfg)
    tmask = batch['turn_mask']
    diag = {
        'rho_clip': ((rhos > clip_rho) * tmask).sum(),
        'c_clip': ((rhos > clip_c) * tmask).sum(),
        'rho_sum': (rhos * tmask).sum(),
        'rho_sq_sum': (rhos.square() * tmask).sum(),
    }
    return losses['total'], {'losses': losses, 'data_count': dcnt,
                             'diag': diag}
