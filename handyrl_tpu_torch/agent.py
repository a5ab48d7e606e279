"""Match-time host agents: the subset of ``handyrl_tpu/agent.py`` the
learner's online evaluation uses. The agent protocol is ``reset`` /
``action`` / ``observe``, each taking ``(env, player, show)``; the
model-driven agents wait for the evaluation stack's match engines."""

from __future__ import annotations

import random
from typing import Optional


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
