"""Environment protocol and registry (copy of ``handyrl_tpu/environment.py``
for the games the port has: TicTacToe, ParallelTicTacToe, Geister,
ConnectX and HungryGeese).

Environments are plain Python: the framework consumes only the numpy
arrays they produce (``observation``) and the integer action spaces they
define (``legal_actions``). ``net()`` returns the port's torch module.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional

# short name -> module path; a fully-qualified dotted module path also works
ENVS = {
    'TicTacToe': 'handyrl_tpu_torch.envs.tictactoe',
    'ParallelTicTacToe': 'handyrl_tpu_torch.envs.parallel_tictactoe',
    'Geister': 'handyrl_tpu_torch.envs.geister',
    'ConnectX': 'handyrl_tpu_torch.envs.kaggle.connectx',
    'HungryGeese': 'handyrl_tpu_torch.envs.kaggle.hungry_geese',
}


# tensor twins: envs as batched torch functions for the device-resident
# loop (device_generation.py), the JAX package's JAX_ENVS
DEVICE_ENVS = {
    'HungryGeese': 'handyrl_tpu_torch.envs.torch_hungry_geese',
    'TicTacToe': 'handyrl_tpu_torch.envs.torch_tictactoe',
    'Geister': 'handyrl_tpu_torch.envs.torch_geister',
    'ConnectX': 'handyrl_tpu_torch.envs.torch_connectx',
}


def make_device_env(env_args: Dict[str, Any]):
    """The tensor twin module of an env (the JAX package's
    ``make_jax_env``); raises for an env that has none."""
    name = env_args['env']
    if name not in DEVICE_ENVS:
        raise ValueError('env %r has no device twin in the port' % (name,))
    return importlib.import_module(DEVICE_ENVS[name])


def _resolve_module(env_args: Dict[str, Any]):
    name = env_args['env']
    return importlib.import_module(ENVS.get(name, name))


def make_env(env_args: Dict[str, Any]) -> 'BaseEnvironment':
    module = _resolve_module(env_args)
    return module.Environment(env_args)


class BaseEnvironment:
    """Base class every game implements.

    Required in all games: ``reset``, ``terminal``, ``outcome``,
    ``legal_actions``, ``observation`` and either ``play`` (turn-based) or a
    custom ``step`` (simultaneous). ``diff_info``/``update``/``action2str``/
    ``str2action`` rebuild a mirror environment from per-step deltas.
    """

    def __init__(self, args: Optional[Dict[str, Any]] = None):
        pass

    def __str__(self) -> str:
        return ''

    # -- core transitions -------------------------------------------------
    def reset(self, args: Optional[Dict[str, Any]] = None):
        raise NotImplementedError()

    def play(self, action: int, player: Optional[int] = None):
        """Apply one player's action (turn-based games)."""
        raise NotImplementedError()

    def step(self, actions: Dict[int, Optional[int]]):
        """Apply a dict of simultaneous actions; default defers to play()."""
        for player, action in actions.items():
            if action is not None:
                self.play(action, player)

    # -- whose move -------------------------------------------------------
    def turn(self) -> int:
        return 0

    def turns(self) -> List[int]:
        return [self.turn()]

    def observers(self) -> List[int]:
        """Players that should observe (for RNN state) without acting."""
        return []

    # -- termination and scoring -----------------------------------------
    def terminal(self) -> bool:
        raise NotImplementedError()

    def reward(self) -> Dict[int, float]:
        """Immediate per-step rewards (optional)."""
        return {}

    def outcome(self) -> Dict[int, float]:
        raise NotImplementedError()

    # -- action/observation spaces ---------------------------------------
    def legal_actions(self, player: Optional[int] = None) -> List[int]:
        raise NotImplementedError()

    def players(self) -> List[int]:
        return [0]

    def observation(self, player: Optional[int] = None):
        raise NotImplementedError()

    # -- string codec (network battle mode) ------------------------------
    def action2str(self, a: int, player: Optional[int] = None) -> str:
        return str(a)

    def str2action(self, s: str, player: Optional[int] = None) -> int:
        return int(s)

    def diff_info(self, player: Optional[int] = None):
        return ''

    def update(self, info, reset: bool):
        raise NotImplementedError()

    # -- model hook -------------------------------------------------------
    def net(self):
        """Return the torch module for this game (optional)."""
        raise NotImplementedError()
