"""Opponents of the learner's online evaluation: the subset of
``handyrl_tpu/evaluation.py`` that :class:`generation.BatchedEvaluator`
calls. :func:`build_agent` parses a host agent's name; :func:`load_model`
loads a learner checkpoint (``<epoch>.ckpt``: the param tree in flax's
``to_bytes`` layout, as either package writes it) into the env's net. The
match engines, exported models, the registry and service specs and the
network battle mode are not ported yet."""

from __future__ import annotations

from typing import Any

from .agent import RandomAgent, RuleBasedAgent


def build_agent(raw: str, env=None):
    """'random' or 'rulebase[-key]' as a host agent; None for anything
    else (a model spec)."""
    if raw == 'random':
        return RandomAgent()
    if raw.startswith('rulebase'):
        key = raw.split('-')[1] if '-' in raw else None
        return RuleBasedAgent(key)
    return None


def load_model(model_path: str, env, device: Any = 'cuda'):
    """A learner checkpoint file as a ``ModelWrapper`` on ``device``: the
    env's net with the checkpoint's params."""
    from .model import ModelWrapper, load_params_bytes
    if '://' in model_path or not model_path.endswith('.ckpt'):
        raise ValueError('load_model reads learner checkpoints (.ckpt) only; '
                         '%r is not one' % (model_path,))
    module = env.net()
    with open(model_path, 'rb') as f:
        load_params_bytes(module, f.read())
    return ModelWrapper(module, device)
