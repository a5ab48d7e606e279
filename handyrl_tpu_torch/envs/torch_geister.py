"""Vectorized Geister on tensors: the device-resident twin of
``envs/geister.py``, for the fused loop's 'turn' layout, the split path,
the device evaluator and the device actor.

The port of ``handyrl_tpu/envs/jax_geister.py``. N games advance as one
call. The board is a flat (N, 36) piece-code tensor (-1 empty, else
color * 2 + type, type 0 blue, 1 red); the setup phase is part of the
action space (ids 144..213 pick one of the 70 blue layouts), so the policy
drives it like any other move; moves are encoded from the mover's rotated
perspective, as the host env's codec. The observation is a dict
``{'scalar': (N, 18), 'board': (N, 7, 6, 6)}`` of a viewer's view: the
opponent's piece types hidden, the second player's board rotated 180
degrees.

The move tables are arithmetic on ``arange``; the 70 layouts' piece types
are a table copied to each device once, by :func:`init_state` (always
called before a chunk is captured), so no host-to-device copy runs inside
a CUDA graph's capture.

State (every leaf has the env axis N first):
  board   (N, 36) int8   -1 empty, else color * 2 + type
  color   (N,)    int8   side to move
  plies   (N,)    int32  plies played, from -2 (the two setup plies)
  win     (N,)    int8   -1 none, 0/1 winner, 2 draw
  counts  (N, 4)  int32  pieces alive per piece code
"""

from __future__ import annotations

import itertools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

NUM_PLAYERS = 2
BOARD = 36
N_MOVE = 4 * BOARD          # 144
N_SET = 70
N_ACTIONS = N_MOVE + N_SET  # 214
MAX_PLIES = 200
SIMULTANEOUS = False
# the host env draws a hidden opponent's layout from its own rng, so device
# records cannot replay through the host env byte for byte
RNG_COMPAT = 'device'

BLUE, RED = 0, 1

Tensor = torch.Tensor

# layout -> per-slot piece type (70, 8): the chosen 4 slots are blue
_LAYOUT_TYPES = np.ones((N_SET, 8), np.int64)
for _i, _combo in enumerate(itertools.combinations(range(8), 4)):
    _LAYOUT_TYPES[_i, list(_combo)] = BLUE
_TABLES: Dict[str, Tensor] = {}


class State(NamedTuple):
    board: Tensor
    color: Tensor
    plies: Tensor
    win: Tensor
    counts: Tensor


def _layout_types(device) -> Tensor:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(_LAYOUT_TYPES, device=device)
    return _TABLES[key]


def home_cells(c: Tensor) -> Tensor:
    """(N, 8) flat home cells of the colours ``c`` (N,), in layout-slot
    order: B2 C2 D2 E2 B1 C1 D1 E1 for the first player, their 180-degree
    rotation (E5 D5 C5 B5 E6 D6 C6 B6) for the second."""
    s = torch.arange(8, device=c.device)
    first = (1 + s % 4) * 6 + (1 - s // 4)
    return torch.where(c[:, None] == 1, BOARD - 1 - first, first)


def move_tables(c: Tensor):
    """The move codec of colours ``c`` (N,) for every move id (144): the
    from cell, the to cell (-1 off the board) and whether an off-board
    destination is one of the colour's two goal cells, each (N, 144).
    Move ids are encoded from the mover's rotated perspective."""
    a = torch.arange(N_MOVE, device=c.device)
    d = (a // BOARD)[None, :].expand(c.shape[0], N_MOVE)
    x = (a % BOARD // 6)[None, :]
    y = (a % 6)[None, :]
    second = c[:, None] == 1
    x = torch.where(second, 5 - x, x)
    y = torch.where(second, 5 - y, y)
    d = torch.where(second, 3 - d, d)
    # steps: 0 up (-1, 0), 1 left (0, -1), 2 right (0, 1), 3 down (1, 0)
    tx = x + (d == 3).long() - (d == 0).long()
    ty = y + (d == 2).long() - (d == 1).long()
    onboard = (tx >= 0) & (tx < 6) & (ty >= 0) & (ty < 6)
    to = torch.where(onboard, tx * 6 + ty, torch.full_like(tx, -1))
    goal_col = torch.where(second, 0, 5)
    goal = ~onboard & ((tx == -1) | (tx == 6)) & (ty == goal_col)
    return x * 6 + y, to, goal


def init_state(n: int, seed: int = 0, device='cpu',
               generator: Optional[torch.Generator] = None) -> State:
    """``n`` empty boards before the setup plies, the first player to move
    (``seed`` and ``generator`` are unused: a fresh game draws
    nothing)."""
    board = torch.full((n, BOARD), -1, dtype=torch.int8, device=device)
    _layout_types(board.device)
    return State(
        board=board,
        color=torch.zeros((n,), dtype=torch.int8, device=device),
        plies=torch.full((n,), -2, dtype=torch.int32, device=device),
        win=torch.full((n,), -1, dtype=torch.int8, device=device),
        counts=torch.zeros((n, 4), dtype=torch.int32, device=device))


def turn(state: State) -> Tensor:
    """The acting player's index per env, int64."""
    return state.color.long()


def terminal(state: State) -> Tensor:
    return state.win >= 0


def outcome(state: State) -> Tensor:
    """(N, 2): +1 / -1 for a win, 0 for a draw or an unfinished game."""
    w = state.win
    first = torch.where(w == 0, 1.0, torch.where(w == 1, -1.0, 0.0))
    return torch.stack([first, -first], dim=1)


def rewards(state: State) -> Tensor:
    """(N, 2) per-ply rewards: -0.01 to both players every ply (the host
    env's ``reward``)."""
    n = state.board.shape[0]
    return torch.full((n, NUM_PLAYERS), -0.01, dtype=torch.float32,
                      device=state.board.device)


def legal_mask(state: State) -> Tensor:
    """(N, 214) float32, 1 = legal for the side to move."""
    n = state.board.shape[0]
    setup = state.plies < 0
    c = state.color.long()
    piece = state.board.long()
    frm, to, goal = move_tables(c)
    own = (piece >= 0) & (piece // 2 == c[:, None])               # (N, 36)
    own_from = torch.gather(own, 1, frm)                           # (N, 144)
    to_piece = torch.gather(piece, 1, to.clamp(min=0))
    to_own = (to_piece >= 0) & (to_piece // 2 == c[:, None])
    onboard_ok = (to >= 0) & ~to_own
    from_type = torch.remainder(torch.gather(piece, 1, frm), 2)
    goal_ok = (to < 0) & goal & (from_type == BLUE)
    move_legal = own_from & (onboard_ok | goal_ok) & ~setup[:, None]
    return torch.cat([move_legal, setup[:, None].expand(n, N_SET)],
                     dim=1).float()


def step(state: State, actions: Tensor,
         generator: Optional[torch.Generator] = None) -> State:
    """One ply per env (callers feed legal actions only): a setup ply
    places the mover's 8 pieces by the chosen layout, a move ply moves,
    captures or escapes; then the wins and the 200-ply draw."""
    n = state.board.shape[0]
    dev = state.board.device
    rows = torch.arange(n, device=dev)
    c = state.color.long()
    base = c * 2
    setup = state.plies < 0
    actions = actions.long()

    # setup branch: 8 pieces by the chosen layout
    layout = (actions - N_MOVE).clamp(0, N_SET - 1)
    types = _layout_types(dev)[layout]                            # (N, 8)
    home = home_cells(c)                                          # (N, 8)
    set_board = state.board.clone()
    set_board.scatter_(1, home, torch.where(
        setup[:, None], (base[:, None] + types).to(torch.int8),
        torch.gather(state.board, 1, home)))
    # a setup places 4 blue and 4 red for the mover
    onehot = torch.nn.functional.one_hot
    setup_add = (onehot(base, 4) + onehot(base + 1, 4)).int() * 4
    set_counts = state.counts + torch.where(setup[:, None], setup_add,
                                            torch.zeros_like(setup_add))

    # move branch
    a = actions.clamp(0, N_MOVE - 1)
    frm_t, to_t, goal_t = move_tables(c)
    frm = torch.gather(frm_t, 1, a[:, None])[:, 0]
    to = torch.gather(to_t, 1, a[:, None])[:, 0]
    is_goal = torch.gather(goal_t, 1, a[:, None])[:, 0] & (to < 0)
    moving = state.board[rows, frm]
    target = state.board[rows, to.clamp(min=0)]
    captures = ~setup & (to >= 0) & (target >= 0)
    cap_code = target.long().clamp(0, 3)

    move_board = state.board.clone()
    move_board[rows, frm] = torch.where(setup, moving,
                                        torch.full_like(moving, -1))
    dest = to.clamp(min=0)
    move_board[rows, dest] = torch.where(~setup & (to >= 0), moving,
                                         move_board[rows, dest])
    zeros4 = torch.zeros_like(set_counts)
    move_counts = set_counts - torch.where(
        captures[:, None], onehot(cap_code, 4).int(), zeros4)
    # a goal escape removes the escaping piece from the counts
    escape = ~setup & is_goal
    move_counts = move_counts - torch.where(
        escape[:, None], onehot(moving.long().clamp(0, 3), 4).int(), zeros4)

    board = torch.where(setup[:, None], set_board, move_board)
    counts = torch.where(setup[:, None], set_counts, move_counts)

    # wins
    opp = 1 - c
    left = torch.gather(counts, 1, torch.stack([opp * 2 + BLUE,
                                                opp * 2 + RED], dim=1))
    cap_blue = captures & (torch.remainder(cap_code, 2) == BLUE)
    cap_red = captures & (torch.remainder(cap_code, 2) == RED)
    cap_all_blue = cap_blue & (left[:, 0] == 0)
    cap_all_red = cap_red & (left[:, 1] == 0)
    plies = state.plies + 1
    c8, opp8 = c.to(torch.int8), opp.to(torch.int8)
    win = state.win
    win = torch.where(~setup & is_goal, c8, win)
    win = torch.where(cap_all_blue & (win < 0), c8, win)
    win = torch.where(cap_all_red & (win < 0), opp8, win)
    win = torch.where((plies >= MAX_PLIES) & (win < 0),
                      torch.full_like(win, 2), win)
    return State(board=board, color=(1 - state.color).to(torch.int8),
                 plies=plies, win=win, counts=counts)


def observe(state: State) -> Dict[str, Tensor]:
    """The side to move's view (:func:`observe_as`)."""
    return observe_as(state, state.color.long())


def observe_as(state: State, viewer: Tensor) -> Dict[str, Tensor]:
    """The view of the (N,) ``viewer`` seats (the host env's
    ``observation(player)``): the board from the viewer's perspective, the
    opponent's piece types hidden, the turn bit set when the viewer is to
    move. ``{'scalar': (N, 18), 'board': (N, 7, 6, 6)}`` float32."""
    c = viewer.long()
    opp = 1 - c
    piece = state.board.long()
    turn_view = state.color.long() == c
    codes = torch.stack([c * 2 + BLUE, c * 2 + RED, opp * 2 + BLUE,
                         opp * 2 + RED], dim=1)
    n_alive = torch.gather(state.counts, 1, codes).long()          # (N, 4)
    # one-hot of 1..4 alive (all zeros for none)
    k = torch.arange(1, 5, device=c.device)
    counts_1h = (n_alive[:, :, None] == k).float().reshape(-1, 16)
    scalar = torch.cat([(c == 0).float()[:, None],
                        turn_view.float()[:, None], counts_1h], dim=1)
    my_b = (piece == (c * 2 + BLUE)[:, None]).float()
    my_r = (piece == (c * 2 + RED)[:, None]).float()
    op_any = ((piece >= 0) & (piece // 2 == opp[:, None])).float()
    zeros = torch.zeros_like(my_b)
    planes = torch.stack([torch.ones_like(my_b), my_b + my_r, op_any, my_b,
                          my_r, zeros, zeros], dim=1)              # (N, 7, 36)
    # the second player's board rotated 180 degrees
    planes = torch.where((c == 1)[:, None, None], planes.flip(-1), planes)
    return {'scalar': scalar, 'board': planes.reshape(-1, 7, 6, 6)}


def auto_reset(state: State, done: Tensor,
               generator: Optional[torch.Generator] = None) -> State:
    """Fresh games where ``done``."""
    fresh = init_state(state.board.shape[0], device=state.board.device)

    def pick(f: Tensor, s: Tensor) -> Tensor:
        return torch.where(done.reshape((-1,) + (1,) * (s.dim() - 1)), f, s)

    return State(*(pick(f, s) for f, s in zip(fresh, state)))
