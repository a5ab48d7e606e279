"""Action sampling and bucketed inference.

The subset of ``handyrl_tpu/generation.py`` the serving path uses: the ONE
audited sampling routine shared by a local ply and the inference engine.
Sampling is keyed by an explicit seed sequence instead of process-global
RNG state, so a draw is a pure function of (seed sequence, policy, legal
actions): the engine replays any caller's draw bit-identically however
requests interleave. The episode generators are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from .utils.tree import map_structure, softmax, stack_structure


def sample_seed(base_seed, episode_key: Sequence[int], draw_index: int
                ) -> List[int]:
    """Deterministic per-draw seed sequence for np.random.default_rng.

    ``episode_key`` identifies the episode (the server-stamped
    ``sample_key``, or a worker-local fallback stream); ``draw_index``
    counts action draws within the episode in play order."""
    seq = (int(base_seed), *(int(k) for k in episode_key), int(draw_index))
    return [k & 0xFFFFFFFFFFFFFFFF for k in seq]


def masked_sample_batch(policies: np.ndarray, legal_lists, seed_seqs):
    """Sample one action per row from the legality-masked softmax.

    Vectorized over rows: the mask build and the softmax (the hot part) run
    as single array ops; the draw itself is one inverse-CDF lookup per row
    from that row's own seeded generator. Returns
    ``(actions[int64], selected_probs[float32], action_masks[float32])``;
    the mask rows use the reference's +1e32 illegal penalty so recorded
    ``action_mask`` entries stay contract-identical.
    """
    policies = np.asarray(policies)
    masks = np.full(policies.shape, 1e32, policies.dtype)
    for n, legal in enumerate(legal_lists):
        masks[n, list(legal)] = 0
    probs = softmax(policies - masks)
    actions = np.empty(len(legal_lists), np.int64)
    selected = np.empty(len(legal_lists), policies.dtype)
    for n, (legal, seq) in enumerate(zip(legal_lists, seed_seqs)):
        legal = list(legal)
        cum = np.cumsum(probs[n, legal], dtype=np.float64)
        u = np.random.default_rng(seq).random() * cum[-1]
        idx = min(int(np.searchsorted(cum, u, side='right')), len(legal) - 1)
        actions[n] = legal[idx]
        selected[n] = probs[n, legal[idx]]
    return actions, selected, masks


def masked_sample(policy: np.ndarray, legal_actions, seed_seq) -> tuple:
    """B=1 view of :func:`masked_sample_batch`.

    Returns (action, prob_of_action, action_mask)."""
    actions, selected, masks = masked_sample_batch(
        np.asarray(policy)[None], [legal_actions], [seed_seq])
    return int(actions[0]), selected[0], masks[0]


def bucketed_inference(model, obs, hidden=None) -> Dict[str, Any]:
    """Single-sample forward through the power-of-two-bucket batched program.

    The inference engine runs padded power-of-two buckets; routing the
    sequential path through the same bucketed forward keeps a local ply
    bit-identical to one the engine serves. Models without
    ``batch_inference`` (RandomModel, wire proxies) use their own
    ``inference``."""
    batch = getattr(model, 'batch_inference', None)
    if batch is None:
        return model.inference(obs, hidden)
    obs_b, _ = pad_to_bucket([obs])
    hidden_b = None
    if hidden is not None:
        hidden_b, _ = pad_to_bucket([hidden])
    outputs = batch(obs_b, hidden_b)
    out = {}
    for k, v in outputs.items():
        if v is None:
            continue
        if k == 'hidden':
            out[k] = map_structure(lambda a: np.asarray(a)[0], v)
        else:
            out[k] = np.asarray(v)[0]
    return out


def model_act(model, obs, hidden, legal_actions, seed_seq) -> Dict[str, Any]:
    """One acting ply: forward pass + masked sample.

    Models that expose ``act`` (service proxies) run both halves
    server-side in a coalesced batch; everything else runs the local
    bucketed forward and the same shared sampler."""
    act = getattr(model, 'act', None)
    if act is not None:
        return act(obs, hidden, legal_actions, seed_seq)
    outputs = bucketed_inference(model, obs, hidden)
    action, prob, mask = masked_sample(outputs['policy'], legal_actions,
                                       seed_seq)
    return {'action': action, 'prob': prob, 'action_mask': mask,
            'value': outputs.get('value'), 'hidden': outputs.get('hidden')}


def pad_to_bucket(structures: list, min_bucket: int = 8):
    """Stack a list of pytrees row-wise and pad the row count to a
    power-of-two bucket (replicating row 0), so batches of any row count
    run at a few fixed shapes (the JAX package's bucket contract).

    Returns ``(padded_batch, true_rows)``."""
    rows = len(structures)
    bucket = max(min_bucket, 1 << (rows - 1).bit_length())
    pad = bucket - rows

    def pad_rows(x):
        if pad == 0:
            return x
        return np.concatenate([x, np.repeat(x[:1], pad, axis=0)], axis=0)

    return map_structure(pad_rows, stack_structure(structures)), rows
