"""Vectorized TicTacToe on tensors: the device-resident twin of
``envs/tictactoe.py``, for the fused loop's 'turn' layout.

The port of ``handyrl_tpu/envs/jax_tictactoe.py``. N boards advance as one
call: reset, legal mask, win detection, observation and auto-reset are
tensor ops, so a rollout chunk can be captured as one CUDA graph. The win
lines are computed with ``arange`` and arithmetic on the boards' device,
never built from a Python list inside a call (a host-to-device copy
cannot run inside a graph capture); ``WIN_LINES`` is the host env's table,
which they equal.

State (every leaf has the env axis N first):
  boards  (N, 9)  int8   +1 black / -1 white / 0 empty
  side    (N,)    int8   side to move (+1/-1)
  winner  (N,)    int8   +1/-1 once decided, 0 otherwise
  moves   (N,)    int8   plies played

Turn-based protocol (device_generation.py): ``turn`` -> (N,) acting
player, ``observe`` -> (N, 3, 3, 3), ``step`` takes (N,) actions. The env
draws nothing, so ``generator`` is accepted and unused, and the records of
a game replay exactly through the host env (``RNG_COMPAT = 'strict'``).
It has no ``greedy_action``: a 'rulebase' opponent plays on the host
evaluator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

N_ACTIONS = 9
MAX_STEPS = 9
NUM_PLAYERS = 2
# deterministic given the actions: records replay byte for byte through
# the host env
RNG_COMPAT = 'strict'

WIN_LINES = (
    (0, 1, 2), (3, 4, 5), (6, 7, 8),   # rows
    (0, 3, 6), (1, 4, 7), (2, 5, 8),   # columns
    (0, 4, 8), (2, 4, 6),              # diagonals
)

Tensor = torch.Tensor


class State(NamedTuple):
    boards: Tensor
    side: Tensor
    winner: Tensor
    moves: Tensor


def win_lines(device) -> Tensor:
    """``WIN_LINES`` as an (8, 3) int64 tensor on ``device``, from
    ``arange``: rows 3r + c, columns r + 3c, the diagonals 4i and 2 + 2i."""
    i = torch.arange(3, device=device)
    rows = 3 * i[:, None] + i[None, :]
    cols = i[:, None] + 3 * i[None, :]
    return torch.cat([rows, cols, (4 * i)[None], (2 + 2 * i)[None]])


def init_state(n: int, seed: int = 0, device='cpu',
               generator: Optional[torch.Generator] = None) -> State:
    """``n`` empty boards, black to move (``seed`` and ``generator`` are
    unused: a fresh game draws nothing)."""
    return State(
        boards=torch.zeros((n, 9), dtype=torch.int8, device=device),
        side=torch.ones((n,), dtype=torch.int8, device=device),
        winner=torch.zeros((n,), dtype=torch.int8, device=device),
        moves=torch.zeros((n,), dtype=torch.int8, device=device))


def legal_mask(state: State) -> Tensor:
    """(N, 9) float32, 1 = legal."""
    return (state.boards == 0).float()


def terminal(state: State) -> Tensor:
    return (state.winner != 0) | (state.moves >= MAX_STEPS)


def turn(state: State) -> Tensor:
    """The acting player's index (0 black, 1 white) per env, int64."""
    return torch.remainder(state.moves.long(), 2)


def observe(state: State) -> Tensor:
    """The side to move's view, (N, 3, 3, 3) float32: [1, mine, theirs]."""
    side = state.side[:, None]
    mine = (state.boards == side).float()
    theirs = (state.boards == -side).float()
    planes = torch.stack([torch.ones_like(mine), mine, theirs], dim=1)
    return planes.reshape(-1, 3, 3, 3)


def step(state: State, actions: Tensor,
         generator: Optional[torch.Generator] = None) -> State:
    """One move per env (an env already over is replaced by the caller's
    ``auto_reset`` before it moves again)."""
    n = state.boards.shape[0]
    rows = torch.arange(n, device=state.boards.device)
    boards = state.boards.clone()
    boards[rows, actions.long()] = state.side
    line_sums = boards[:, win_lines(boards.device)].int().sum(dim=2)
    won = (line_sums == 3 * state.side[:, None].int()).any(dim=1)
    winner = torch.where(won & (state.winner == 0), state.side, state.winner)
    return State(boards=boards, side=-state.side, winner=winner,
                 moves=state.moves + 1)


def outcome(state: State) -> Tensor:
    """(N, 2) float32 outcome by seat (seat 0 is black)."""
    w = state.winner.float()
    return torch.stack([w, -w], dim=1)


def auto_reset(state: State, done: Tensor,
               generator: Optional[torch.Generator] = None) -> State:
    """Fresh boards where ``done``."""
    fresh = init_state(state.boards.shape[0], device=state.boards.device)

    def pick(f: Tensor, s: Tensor) -> Tensor:
        return torch.where(done.reshape((-1,) + (1,) * (s.dim() - 1)), f, s)

    return State(*(pick(f, s) for f, s in zip(fresh, state)))
