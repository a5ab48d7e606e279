"""Forward pass and loss composition for the update step.

The port of ``handyrl_tpu/ops/losses.py`` (itself the reference training
pipeline, train.py:127-267): the same masks, importance-sampling clipping,
two-player value symmetrization and terminal bootstrap. Feed-forward nets
fold (B, T, P) into one batch dimension and run the net once; recurrent
nets step over T with each player's hidden state gated by whether that
player observed the step, the burn-in steps first in a pass without
gradients (the JAX package's ``stop_gradient`` on the carried state).
Losses are sums, not means, so the learning-rate schedule sees the true
data count.

The targets go through ``ops/targets.py``, which launches the CUDA kernels
K3-K5 for tensors on the card.

A ``norm_kind='batch'`` net trains as the JAX package's does: with
``batch_stats`` (its running averages by buffer name) the forward runs in
training mode, normalising by the batch's statistics, and the running
averages advance once a window for a feed-forward net and once a step for
a recurrent one, burn-in steps included; they come back in
``aux['batch_stats']``, without gradients.

With ``target_params`` and ``target_clip`` > 0 the loss runs the IMPACT
clipped target network (losses.py:229-352 there): a second forward under
``torch.no_grad`` with the target's parameters (a 'batch' net's target
normalizes by the batch's statistics and its running averages never
advance) gives the importance ratio pi_target / mu of the V-trace
corrections, clipped at ``target_clip`` for rho and at 1 for c; the
policy gradient still differentiates the current policy's log-prob.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..utils.tree import map_zip, map_structure
from .targets import compute_target

Tensor = torch.Tensor


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
    # IMPACT clipped target network's rho ceiling; 0 = off
    target_clip: float = 0.0


def _fold_bt(x: Tensor) -> Tensor:
    """(B, T, P, ...) -> (B*T*P, ...)"""
    return x.reshape((-1,) + tuple(x.shape[3:]))


def _apply(apply_fn: Callable, params, obs, hidden, batch_stats):
    """One forward: ``(outputs, None)`` in inference mode, or, with
    ``batch_stats``, ``apply_fn(..., batch_stats=...)``'s training-mode
    ``(outputs, advanced running averages)``."""
    if batch_stats is None:
        return dict(apply_fn(params, obs, hidden)), None
    out, new_bs = apply_fn(params, obs, hidden, batch_stats=batch_stats)
    return dict(out), new_bs


def _recurrent_outputs(apply_fn: Callable, params, hidden,
                       batch: Dict[str, Any], cfg: LossConfig,
                       batch_stats=None):
    """A recurrent net stepped over the window's T steps: (B, T, P_obs,
    ...) outputs, zeros at the burn-in steps, and the running averages
    after the last step (None without ``batch_stats``). ``hidden`` is the
    (B, P, ...) state at the window's start; at each step a player's state
    enters gated by its observation mask and is replaced by the net's next
    state where the player observed. The burn-in steps run without
    gradients, so the state they leave is a constant of the loss; they
    advance the running averages all the same."""
    B, T, P_obs = batch['action'].shape[:3]
    omask = batch['observation_mask']                        # (B, T, P, 1)
    bs = [batch_stats]

    def step(h_carry, t):
        omask_t = omask[:, t]

        def gate(h):
            return h * omask_t.reshape(omask_t.shape[:2]
                                       + (1,) * (h.dim() - 2))
        gated = map_structure(gate, h_carry)
        obs_t = map_structure(lambda o: o[:, t], batch['observation'])
        if cfg.turn_based_training and not cfg.observation:
            # only the turn player observed: summing the player axis
            # selects their state (the others were zeroed)
            h_in = map_structure(lambda h: h.sum(dim=1), gated)
            obs_in = map_structure(
                lambda o: o.reshape((B,) + tuple(o.shape[2:])), obs_t)
        else:
            h_in = map_structure(
                lambda h: h.reshape((-1,) + tuple(h.shape[2:])), gated)
            obs_in = map_structure(
                lambda o: o.reshape((-1,) + tuple(o.shape[2:])), obs_t)
        out, bs[0] = _apply(apply_fn, params, obs_in, h_in, bs[0])
        next_h = map_structure(
            lambda h: h.reshape((B, -1) + tuple(h.shape[1:])),
            out.pop('hidden'))
        out = {k: v.reshape((B, P_obs) + tuple(v.shape[1:]))
               for k, v in out.items() if v is not None}

        def merge(h, nh):
            m = omask_t.reshape(omask_t.shape[:2] + (1,) * (h.dim() - 2))
            return h * (1 - m) + nh * m
        return map_zip(merge, h_carry, next_h), out

    bi = cfg.burn_in_steps
    if bi > 0:
        with torch.no_grad():
            for t in range(bi):
                hidden, _ = step(hidden, t)
    steps = []
    for t in range(bi, T):
        hidden, out = step(hidden, t)
        steps.append(out)
    outputs = {k: torch.stack([o[k] for o in steps], dim=1)
               for k in steps[0]}
    if bi > 0:
        # zero outputs at the burn-in steps, so the slicing downstream is
        # the feed-forward path's
        outputs = {k: torch.cat([v.new_zeros(v.shape[:1] + (bi,)
                                             + v.shape[2:]), v], dim=1)
                   for k, v in outputs.items()}
    return outputs, bs[0]


def forward_prediction(apply_fn: Callable, params, hidden,
                       batch: Dict[str, Any], cfg: LossConfig,
                       batch_stats=None):
    """Run the net over a training window: a feed-forward net (``hidden``
    None) once, ``apply_fn(params, obs, None)`` on the
    (B*T*P_obs)-folded observations; a recurrent one step by step from
    ``hidden`` (:func:`_recurrent_outputs`). Returns outputs shaped (B, T,
    P, ...) with the policy turn-gathered and masked by the legal actions,
    and every other output masked by observation_mask; with
    ``batch_stats`` (a 'batch' net's running averages) the forward runs in
    training mode and ``(outputs, advanced running averages)`` comes
    back."""
    B, T, P_obs = batch['action'].shape[:3]
    if hidden is None:
        obs = map_structure(_fold_bt, batch['observation'])
        out, new_bs = _apply(apply_fn, params, obs, None, batch_stats)
        outputs = {k: v.reshape((B, T, P_obs) + tuple(v.shape[1:]))
                   for k, v in out.items()
                   if k != 'hidden' and v is not None}
    else:
        outputs, new_bs = _recurrent_outputs(apply_fn, params, hidden,
                                             batch, cfg, batch_stats)
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
    if batch_stats is None:
        return masked
    return masked, new_bs


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
    ('data_count'), the off-policy diagnostics ('diag') and, given a
    'batch' net's ``batch_stats``, the advanced running averages
    ('batch_stats').

    ``target_params`` (the target network's parameters, and a 'batch'
    net's running averages under ``batch_stats``'s names) with
    ``cfg.target_clip`` > 0 engages the IMPACT target: the V-trace rhos
    and cs come from pi_target / mu, and ``diag`` gains
    'target_clip', 'target_ratio_sum' and 'target_gap_sum'."""
    outputs = forward_prediction(apply_fn, params, init_hidden, batch, cfg,
                                 batch_stats)
    new_bs = None
    if batch_stats is not None:
        outputs, new_bs = outputs

    use_target = target_params is not None and cfg.target_clip > 0
    tgt_outputs = None
    if use_target:
        t_bs = None
        if batch_stats is not None:
            t_bs = {k: target_params[k] for k in batch_stats}
        t_params = {k: v for k, v in target_params.items()
                    if t_bs is None or k not in t_bs}
        with torch.no_grad():
            tgt_outputs = forward_prediction(apply_fn, t_params, init_hidden,
                                             batch, cfg, t_bs)
        if t_bs is not None:
            tgt_outputs, _ = tgt_outputs   # the target's stats stay put

    bi = cfg.burn_in_steps
    if bi > 0:
        batch = _slice_burn_in(batch, bi)
        outputs = {k: v[:, bi:] for k, v in outputs.items()}
        if tgt_outputs is not None:
            tgt_outputs = {k: v[:, bi:] for k, v in tgt_outputs.items()}

    actions = batch['action'].long()
    emasks = batch['episode_mask']
    omasks = batch['observation_mask']
    value_target_masks = omasks
    clip_rho, clip_c = 1.0, 1.0

    log_b = torch.log(torch.clamp(batch['selected_prob'], 1e-16, 1)) * emasks
    logp = torch.log_softmax(outputs['policy'], dim=-1)
    log_t = torch.gather(logp, -1, actions) * emasks

    rhos = torch.exp(log_t.detach() - log_b)
    if use_target:
        logp_tgt = torch.log_softmax(tgt_outputs['policy'], dim=-1)
        log_tgt = torch.gather(logp_tgt, -1, actions) * emasks
        rhos_tgt = torch.exp(log_tgt - log_b)
        clipped_rhos = torch.clamp(rhos_tgt, 0, cfg.target_clip)
        cs = torch.clamp(rhos_tgt, 0, clip_c)
    else:
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
    if use_target:
        # the target's health: its clip fraction, the mean target /
        # behavior ratio and the current-vs-target log-prob gap on the
        # taken actions (how far the live policy moved since the sync)
        diag['target_clip'] = ((rhos_tgt > cfg.target_clip) * tmask).sum()
        diag['target_ratio_sum'] = (rhos_tgt * tmask).sum()
        diag['target_gap_sum'] = ((log_t.detach() - log_tgt) * tmask).sum()
    aux = {'losses': losses, 'data_count': dcnt, 'diag': diag}
    if new_bs is not None:
        aux['batch_stats'] = new_bs
    return losses['total'], aux


def _slice_burn_in(batch: Dict[str, Any], bi: int) -> Dict[str, Any]:
    """Drop the burn-in steps from every time-indexed entry (entries with
    a time axis of 1, such as the outcome, pass through, as the JAX
    package's ``_slice_burn_in``)."""
    def cut(v):
        return v if v.shape[1] <= 1 else v[:, bi:]
    return {k: map_structure(cut, v) if isinstance(v, (dict, list, tuple))
            else cut(v) for k, v in batch.items()}
