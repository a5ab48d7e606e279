"""Vectorized Hungry Geese on tensors: the flagship env as batched torch
functions, the device-resident twin of ``envs/kaggle/hungry_geese.py``.

The port of ``handyrl_tpu/envs/jax_hungry_geese.py``. N games of four geese
advance as one call. Bodies are fixed-size ordered cell buffers (head at
index 0) with explicit lengths; movement is a shift, growth and starvation
are length edits, collisions are scatter-counts on the 7x11 board, and
food respawns uniformly over the empty cells. No shape depends on the data
and nothing reads a device value on the host, so a whole rollout chunk can
be captured as one CUDA graph.

Draws: ``step`` (food respawn), ``auto_reset`` (fresh boards) and
``greedy_action`` (its random fallback) take their uniforms as an argument
or draw them from ``generator``. A uniform u picks the floor(u * n)-th of
the n empty cells (ascending cell id), the same distribution as the JAX
twin's categorical draw over them; the two food slots are refilled in turn,
so slot 1's draw excludes the food slot 0 just placed. The JAX twin keeps a
PRNG key per env in its state; here the caller's ``torch.Generator``
carries the stream, so ``State`` has no key.

Simultaneous-move protocol (device_generation.py): ``SIMULTANEOUS``,
``observe`` -> (N, P, 17, 7, 11), ``step`` takes (N, P) actions,
``acting`` -> (N, P) mask of the geese that act.

Constants are computed with ``arange`` and arithmetic, never built from
Python lists, because a host-to-device copy cannot run inside a graph
capture.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

R, C = 7, 11
N_CELLS = R * C
NUM_PLAYERS = 4
N_ACTIONS = 4
MAX_LEN = N_CELLS
HUNGER_RATE = 40
MAX_STEPS = 200
N_FOOD = 2
MAX_LEN_SCORE = N_CELLS + 1
SIMULTANEOUS = True
# food and fresh boards come from the device generator; the host simulator
# cannot replay them, so records of this env are not byte-comparable
RNG_COMPAT = 'device'

Tensor = torch.Tensor


class State(NamedTuple):
    cells: Tensor        # (N, P, MAX_LEN) int32 ordered cell ids, head first
    length: Tensor       # (N, P) int32; 0 = gone
    alive: Tensor        # (N, P) bool
    food: Tensor         # (N, N_FOOD) int32 cell ids
    last_action: Tensor  # (N, P) int32; -1 = none yet
    prev_heads: Tensor   # (N, P) int32; -1 = none
    steps: Tensor        # (N,) int32
    scores: Tensor       # (N, P) float32


def _drow(actions: Tensor) -> Tensor:
    """NORTH, SOUTH, WEST, EAST -> row delta -1, 1, 0, 0."""
    return (actions == 1).int() - (actions == 0).int()


def _dcol(actions: Tensor) -> Tensor:
    return (actions == 3).int() - (actions == 2).int()


def _opposite(actions: Tensor) -> Tensor:
    """0 <-> 1, 2 <-> 3."""
    return torch.bitwise_xor(actions, 1)


def _move_cells(cells: Tensor, actions: Tensor) -> Tensor:
    """Cell ids one move away (floor division and remainder, as the JAX
    twin's ``//`` and ``%``, so the stale -1 heads of gone geese move the
    same way)."""
    r = torch.div(cells, C, rounding_mode='floor')
    c = torch.remainder(cells, C)
    return (torch.remainder(r + _drow(actions), R) * C
            + torch.remainder(c + _dcol(actions), C)).int()


def _one_hot_count(ids: Tensor, lead: int) -> Tensor:
    """Counts of each cell id over ``ids``' dims after the first ``lead``:
    float32 (..., N_CELLS); id N_CELLS is the out-of-board bucket."""
    shape = ids.shape[:lead]
    flat = ids.reshape(shape + (-1,)).long()
    out = torch.zeros(shape + (N_CELLS + 1,), dtype=torch.float32,
                      device=ids.device)
    out.scatter_add_(lead, flat, torch.ones_like(flat, dtype=torch.float32))
    return out[..., :N_CELLS]


def _body_occupancy(cells: Tensor, length: Tensor, alive: Tensor) -> Tensor:
    """(N, 77) counts of every cell of every live goose, heads included."""
    idx = torch.arange(MAX_LEN, device=cells.device)
    valid = (idx < length[..., None]) & alive[..., None]
    return _one_hot_count(torch.where(valid, cells, N_CELLS), 1)


def _scores(steps: Tensor, length: Tensor, alive: Tensor,
            scores: Tensor) -> Tensor:
    live = ((steps[:, None] + 1) * MAX_LEN_SCORE + length).float()
    return torch.where(alive, live, scores)


def _fresh_boards(u: Tensor):
    """(cells, food) of new games: six distinct cells, the first four the
    geese's heads, from (N, 77) uniforms (their ascending order)."""
    n = u.shape[0]
    picks = torch.argsort(u, dim=1, stable=True)[:, :NUM_PLAYERS + N_FOOD]
    picks = picks.int()
    cells = torch.full((n, NUM_PLAYERS, MAX_LEN), -1, dtype=torch.int32,
                       device=u.device)
    cells[:, :, 0] = picks[:, :NUM_PLAYERS]
    return cells, picks[:, NUM_PLAYERS:].contiguous()


def _uniform(shape, generator: Optional[torch.Generator], device) -> Tensor:
    return torch.rand(shape, generator=generator, device=device)


def init_state(n: int, seed: int = 0, device='cpu',
               generator: Optional[torch.Generator] = None) -> State:
    """``n`` fresh games; the boards are drawn from ``generator``, or from a
    generator on ``device`` seeded with ``seed``."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    cells, food = _fresh_boards(_uniform((n, N_CELLS), generator, device))
    dev = cells.device
    state = State(
        cells=cells,
        length=torch.ones((n, NUM_PLAYERS), dtype=torch.int32, device=dev),
        alive=torch.ones((n, NUM_PLAYERS), dtype=torch.bool, device=dev),
        food=food,
        last_action=torch.full((n, NUM_PLAYERS), -1, dtype=torch.int32,
                               device=dev),
        prev_heads=torch.full((n, NUM_PLAYERS), -1, dtype=torch.int32,
                              device=dev),
        steps=torch.zeros((n,), dtype=torch.int32, device=dev),
        scores=torch.zeros((n, NUM_PLAYERS), dtype=torch.float32,
                           device=dev))
    return state._replace(scores=_scores(state.steps, state.length,
                                         state.alive, state.scores))


def acting(state: State) -> Tensor:
    """(N, P) bool: which geese submit actions this step."""
    return state.alive


def terminal(state: State) -> Tensor:
    return (state.alive.sum(dim=1) <= 1) | (state.steps >= MAX_STEPS)


def legal_mask(state: State) -> Tensor:
    """(N, P, A): every action may be submitted (reference parity)."""
    n = state.cells.shape[0]
    return torch.ones((n, NUM_PLAYERS, N_ACTIONS), dtype=torch.float32,
                      device=state.cells.device)


def outcome(state: State) -> Tensor:
    """Pairwise-rank score in {-1..1}, (N, P)."""
    s = state.scores
    beats = (s[:, :, None] > s[:, None, :]).sum(dim=2).float()
    loses = (s[:, :, None] < s[:, None, :]).sum(dim=2).float()
    return (beats - loses) / (NUM_PLAYERS - 1)


def step(state: State, actions: Tensor, u: Optional[Tensor] = None,
         generator: Optional[torch.Generator] = None) -> State:
    """Apply (N, P) actions; gone geese's actions are ignored. ``u`` (N,
    N_FOOD) are the food draws (from ``generator`` when None).

    The canonical kaggle resolution order (docs/geese_rules.md), as the JAX
    twin: reversal death (even at length 1) -> move + eat -> self-collision
    against the remaining own cells -> hunger pop / starvation -> one
    simultaneous cross-goose occupancy pass -> food respawn."""
    dev = state.cells.device
    actions = actions.long()
    heads = state.cells[:, :, 0]
    prev_heads = torch.where(state.alive, heads, -1).int()

    # 1. reversal deaths: no length guard
    last = state.last_action.long()
    reversed_ = (last >= 0) & (actions == _opposite(last.clamp(0, 3)))
    alive = state.alive & ~reversed_

    # 2. move heads, eat
    new_heads = _move_cells(heads, actions)
    ate = (new_heads[:, :, None] == state.food[:, None, :]).any(dim=2) & alive
    cells = torch.cat([new_heads[:, :, None], state.cells[:, :, :-1]], dim=2)
    length = state.length + ate.int()

    # 3. self-collision before hunger: indices 1..length-1 of the shifted
    # buffer hold the goose after the tail pop, before the head insert
    idx = torch.arange(MAX_LEN, device=dev)
    own_valid = (idx >= 1) & (idx < length[..., None])
    self_hit = ((cells == new_heads[..., None]) & own_valid).any(dim=2) & alive
    alive = alive & ~self_hit

    # 4. starvation every HUNGER_RATE steps
    steps = state.steps + 1
    starve = torch.remainder(steps, HUNGER_RATE) == 0
    length = length - (starve[:, None] & alive).int()
    alive = alive & (length > 0)

    # 5. the simultaneous cross-goose pass
    occ = _body_occupancy(cells, length, alive)
    collided = alive & (torch.gather(occ, 1, cells[:, :, 0].long()) > 1)
    alive = alive & ~collided
    length = torch.where(alive, length, 0).int()

    # scores of the newly gone freeze at their value before this step
    dead_now = state.alive & ~alive
    scores = torch.where(dead_now, state.scores,
                         _scores(steps, length, alive, state.scores))

    # 6. food respawn in the eaten slots, uniform over the empty cells
    occupied = _body_occupancy(cells, length, alive) > 0
    food_eaten = ((state.food[:, None, :] == new_heads[:, :, None])
                  & ate[:, :, None]).any(dim=1)                  # (N, F)
    if u is None:
        u = _uniform((state.cells.shape[0], N_FOOD), generator, dev)
    board = torch.arange(N_CELLS, device=dev)
    slots = list(state.food.unbind(dim=1))
    for i in range(N_FOOD):
        food_now = torch.stack(slots, dim=1)
        empty = ~(occupied | (food_now[:, :, None] == board).any(dim=1))
        n_empty = empty.sum(dim=1)
        k = torch.minimum((u[:, i] * n_empty.float()).long(),
                          (n_empty - 1).clamp(min=0))
        # the k-th empty cell: how many cells hold fewer than k+1 empties
        kth = (empty.int().cumsum(dim=1) <= k[:, None]).sum(dim=1)
        new_cell = torch.where(n_empty > 0, kth, 0).int()
        slots[i] = torch.where(food_eaten[:, i], new_cell, slots[i])
    food = torch.stack(slots, dim=1)

    last_action = torch.where(state.alive, actions.int(), state.last_action)
    return State(cells=cells, length=length, alive=alive, food=food,
                 last_action=last_action, prev_heads=prev_heads,
                 steps=steps, scores=scores)


def _others(per_source: Tensor) -> Tensor:
    """(N, P, 77) bool per source goose -> (N, P, 77): viewer p's OR over
    the other geese q != p."""
    total = per_source.int().sum(dim=1, keepdim=True)
    return (total - per_source.int()) > 0


def greedy_action(state: State, u: Optional[Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Tensor:
    """Vectorized GreedyAgent (N, P), the kaggle rulebase opponent, with
    the host port's decision rules (envs/kaggle/hungry_geese.py
    ``rule_based_action``): a candidate may not reverse, land next to an
    opponent's head, on any goose cell but a tail, or on the tail of an
    opponent about to eat; among candidates the least non-wrapped Manhattan
    distance to the nearest food wins, ties in kaggle's order NORTH, EAST,
    SOUTH, WEST; with no candidate, a uniform action from ``u`` (N, P)."""
    n = state.cells.shape[0]
    dev = state.cells.device
    heads = state.cells[:, :, 0]
    idx = torch.arange(MAX_LEN, device=dev)
    acts = torch.arange(N_ACTIONS, device=dev)
    targets = _move_cells(heads[:, :, None], acts)                 # (N, P, 4)

    # every goose's cells but its tail
    body_valid = (idx < (state.length - 1)[..., None]) & state.alive[..., None]
    bodies = _one_hot_count(torch.where(body_valid, state.cells, N_CELLS),
                            1) > 0                                # (N, 77)
    # the four neighbours of each live goose's head, by source goose
    head_adj = torch.where(state.alive[..., None], targets, N_CELLS)
    adj_src = _one_hot_count(head_adj, 2) > 0                      # (N, P, 77)
    others_adj = _others(adj_src)

    # tails of geese about to eat (a head next to food)
    food_mask = _one_hot_count(state.food, 1) > 0                  # (N, 77)
    eats_next = (adj_src & food_mask[:, None, :]).any(dim=2)
    tail_ix = (state.length - 1).clamp(0, MAX_LEN - 1).long()
    tails = torch.gather(state.cells, 2, tail_ix[..., None])[..., 0]
    tails = torch.where(state.alive & eats_next, tails, N_CELLS)
    others_eating_tails = _others(_one_hot_count(tails[..., None], 2) > 0)

    banned = others_adj | others_eating_tails | bodies[:, None, :]
    hit = torch.gather(banned, 2, targets.long())                  # (N, P, 4)
    last = state.last_action.long()
    reverse = (last[..., None] >= 0) & (
        acts == _opposite(last.clamp(0, 3))[..., None])
    allowed = ~(hit | reverse)

    # non-wrapped Manhattan distance from each target to the nearest food
    tr, tc = torch.div(targets, C, rounding_mode='floor'), targets % C
    fr = torch.div(state.food, C, rounding_mode='floor')
    fc = state.food % C
    dist = ((tr[..., None] - fr[:, None, None, :]).abs()
            + (tc[..., None] - fc[:, None, None, :]).abs()).min(dim=-1).values

    # kaggle's order NORTH, EAST, SOUTH, WEST as a rank < 1 added to the
    # distance, so it only breaks ties: action 0, 3, 1, 2 -> rank 0, 1, 2, 3
    rank = torch.where(acts == 0, 0, torch.where(acts == 3, 1,
                                                 torch.where(acts == 1, 2, 3)))
    score = torch.where(allowed, dist.float() + rank.float() / 8.0,
                        float('inf'))
    best = torch.argmin(score, dim=-1)
    if u is None:
        u = _uniform((n, NUM_PLAYERS), generator, dev)
    fallback = (u * N_ACTIONS).long().clamp(max=N_ACTIONS - 1)
    return torch.where(allowed.any(dim=-1), best, fallback).int()


def observe(state: State) -> Tensor:
    """Per-player observation planes (N, P, 17, 7, 11), the host env's
    channel layout and relative rotation: heads, tails, bodies, previous
    heads (each rotated so the viewer is channel 0), food."""
    n = state.cells.shape[0]
    dev = state.cells.device
    idx = torch.arange(MAX_LEN, device=dev)
    valid = (idx < state.length[..., None]) & state.alive[..., None]
    body = _one_hot_count(torch.where(valid, state.cells, N_CELLS),
                          2).clamp(max=1.0)                         # (N, P, 77)
    head = _one_hot_count(
        torch.where(state.alive, state.cells[:, :, 0], N_CELLS)[..., None], 2)
    tail_ix = (state.length - 1).clamp(0, MAX_LEN - 1).long()
    tail = torch.gather(state.cells, 2, tail_ix[..., None])[..., 0]
    tail = _one_hot_count(torch.where(state.alive, tail, N_CELLS)[..., None],
                          2)
    prev = _one_hot_count(torch.where(state.prev_heads >= 0, state.prev_heads,
                                      N_CELLS)[..., None], 2)
    food = _one_hot_count(state.food, 1)                            # (N, 77)

    # viewer v sees goose q in channel (q - v) % P: rot[v, j] = (j + v) % P
    players = torch.arange(NUM_PLAYERS, device=dev)
    rot = torch.remainder(players[None, :] + players[:, None], NUM_PLAYERS)
    planes = torch.cat([head[:, rot], tail[:, rot], body[:, rot],
                        prev[:, rot],
                        food[:, None, None, :].expand(n, NUM_PLAYERS, 1,
                                                      N_CELLS)], dim=2)
    return planes.reshape(n, NUM_PLAYERS, 17, R, C)


def auto_reset(state: State, done: Tensor, u: Optional[Tensor] = None,
               generator: Optional[torch.Generator] = None) -> State:
    """Fresh games where ``done``; ``u`` (N, 77) are the boards' draws
    (from ``generator`` when None), drawn for every env."""
    n = state.cells.shape[0]
    dev = state.cells.device
    if u is None:
        u = _uniform((n, N_CELLS), generator, dev)
    f_cells, f_food = _fresh_boards(u)
    ones = torch.ones((n, NUM_PLAYERS), dtype=torch.int32, device=dev)
    none = torch.full((n, NUM_PLAYERS), -1, dtype=torch.int32, device=dev)

    def pick(fresh, cur):
        d = done.reshape((-1,) + (1,) * (cur.dim() - 1))
        return torch.where(d, fresh, cur)

    return State(
        cells=pick(f_cells, state.cells),
        length=pick(ones, state.length),
        alive=pick(ones.bool(), state.alive),
        food=pick(f_food, state.food),
        last_action=pick(none, state.last_action),
        prev_heads=pick(none, state.prev_heads),
        steps=pick(torch.zeros_like(state.steps), state.steps),
        scores=pick(torch.full((n, NUM_PLAYERS), float(MAX_LEN_SCORE + 1),
                               device=dev), state.scores),
    )
