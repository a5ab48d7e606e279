"""Match-time policies: the agent kinds of ``handyrl_tpu/agent.py``.

The agent protocol (``reset`` / ``action`` / ``observe``, each taking
``(env, player, show)``) is what the match engines dispatch on
(evaluation.py). The model-driven agents share one core: legal moves are
one helper producing ``-inf``-masked logits; temperature is a parameter of
:class:`Agent` (0 = argmax), so :class:`SoftAgent` is a preset;
:class:`EnsembleAgent` composes member ``Agent`` objects and averages their
heads. A model is anything with ``inference(obs, hidden)`` and
``init_hidden()`` returning numpy (``model.ModelWrapper``).
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

from .utils.tree import softmax


class RandomAgent:
    """Uniform over legal actions; the universal baseline opponent."""

    def reset(self, env, show=False):
        pass

    def action(self, env, player, show=False):
        return random.choice(env.legal_actions(player))

    def observe(self, env, player, show=False):
        return [0.0]


class RuleBasedAgent(RandomAgent):
    """Plays the env's scripted policy when one exists, else random."""

    def __init__(self, key: Optional[str] = None):
        self.key = key

    def action(self, env, player, show=False):
        rule = getattr(env, 'rule_based_action', None)
        if rule is None:
            return super().action(env, player, show)
        return rule(player, key=self.key)


def masked_logits(logits: np.ndarray, legal) -> np.ndarray:
    """Logits with every illegal action driven to -inf."""
    out = np.full_like(logits, -np.inf)
    out[legal] = logits[legal]
    return out


def _show_outputs(env, probs, value):
    """Human-readable policy/value dump; envs may override the format."""
    if hasattr(env, 'print_outputs'):
        env.print_outputs(probs, value)
        return
    if value is not None:
        print('v = %f' % np.asarray(value).reshape(-1)[0])
    if probs is not None:
        print('p = %s' % (probs * 1000).astype(int))


class Agent:
    """Model-driven agent.

    ``temperature`` 0 plays the argmax of the masked policy; otherwise
    actions are sampled from softmax(logits / temperature). Recurrent
    models carry their hidden state across the episode via ``reset``.
    """

    def __init__(self, model, temperature: float = 0.0,
                 observation: bool = True):
        self.model = model
        self.temperature = temperature
        self.observation = observation
        self.hidden = None

    def reset(self, env, show=False):
        self.hidden = self.model.init_hidden()

    def _advance(self, obs) -> dict:
        """One inference step; consumes and refreshes the hidden state."""
        outputs = self.model.inference(obs, self.hidden)
        self.hidden = outputs.pop('hidden', None)
        return outputs

    def _pick(self, logits: np.ndarray) -> int:
        if self.temperature == 0:
            return int(np.argmax(logits))
        probs = softmax(logits / self.temperature)
        return random.choices(range(len(logits)), weights=probs)[0]

    def action(self, env, player, show=False):
        outputs = self._advance(env.observation(player))
        logits = masked_logits(outputs['policy'],
                               env.legal_actions(player))
        if show:
            _show_outputs(env, softmax(logits), outputs.get('value'))
        return self._pick(logits)

    def observe(self, env, player, show=False):
        if not self.observation:
            return None
        value = self._advance(env.observation(player)).get('value')
        if show:
            _show_outputs(env, None, value)
        return value


class EnsembleAgent(Agent):
    """Averages the output heads of several models.

    Built as a committee of member Agents so each member keeps its own
    hidden state; only the averaged heads leave the committee.
    """

    def __init__(self, models, temperature: float = 0.0,
                 observation: bool = True):
        super().__init__(None, temperature, observation)
        self.members = [Agent(m) for m in models]

    def reset(self, env, show=False):
        for member in self.members:
            member.reset(env, show)

    def _advance(self, obs) -> dict:
        heads: dict = {}
        for member in self.members:
            for k, v in member._advance(obs).items():
                heads.setdefault(k, []).append(v)
        return {k: np.mean(vs, axis=0) for k, vs in heads.items()}


class SoftAgent(Agent):
    """Samples at temperature 1 — the exploration-faithful evaluator."""

    def __init__(self, model):
        super().__init__(model, temperature=1.0)
