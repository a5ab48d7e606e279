"""Hungry Geese: 4-player simultaneous survival game on a 7x11 torus.

Copy of ``handyrl_tpu/envs/kaggle/hungry_geese.py`` (the pure-Python
simulator, the 17x7x11 observation planes and the GreedyAgent port), with
``net()`` returning the port's GeeseNet. The tests hold it to the JAX
package's copy move for move.

  * geese move N/S/W/E each step on a wrapping 7x11 grid; reversing onto
    your own neck is death; eating food grows the goose; every 40 steps
    every goose loses a tail cell (starvation at length 0); colliding with
    any goose body, or head-to-head, is death; the game ends when at most
    one goose survives or after 200 steps;
  * per-goose score = survival steps dominating, then length, and the
    outcome is the pairwise-rank score in {-1, -1/3, +1/3, +1};
  * observations are 17x7x11 planes (heads, tails, bodies, previous heads,
    all rotated so the observing player is channel 0, and food), built from
    the last two board states;
  * ``rule_based_action`` is a behavioral port of kaggle's GreedyAgent.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from ...environment import BaseEnvironment

R, C = 7, 11
N_CELLS = R * C
ACTIONS = ['NORTH', 'SOUTH', 'WEST', 'EAST']
DELTAS = [(-1, 0), (1, 0), (0, -1), (0, 1)]
OPPOSITE = {0: 1, 1: 0, 2: 3, 3: 2}
# kaggle's Action enum iterates NORTH, EAST, SOUTH, WEST — the GreedyAgent's
# candidate scan (and thus its tie-breaking) follows that order
GREEDY_ACTION_ORDER = [0, 3, 1, 2]
HUNGER_RATE = 40
MAX_STEPS = 200
N_FOOD = 2
MAX_LEN_SCORE = N_CELLS + 1     # score base so survival dominates length


def _move(cell: int, action: int) -> int:
    x, y = divmod(cell, C)
    dx, dy = DELTAS[action]
    return ((x + dx) % R) * C + (y + dy) % C


class Environment(BaseEnvironment):
    NUM_AGENTS = 4

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        self.args = args or {}
        self.rng = random.Random(self.args.get('id', 0))
        self.reset()

    def reset(self, args: Optional[dict] = None):
        cells = self.rng.sample(range(N_CELLS), self.NUM_AGENTS + N_FOOD)
        self.geese: List[List[int]] = [[c] for c in cells[:self.NUM_AGENTS]]
        self.food: List[int] = cells[self.NUM_AGENTS:]
        self.alive: List[bool] = [True] * self.NUM_AGENTS
        self.scores: List[float] = [0.0] * self.NUM_AGENTS
        self.last_actions: Dict[int, int] = {}
        self.prev_geese: List[List[int]] = [list(g) for g in self.geese]
        self.step_count = 0
        self._update_scores()

    # -- helpers -----------------------------------------------------------
    def _update_scores(self):
        for p in range(self.NUM_AGENTS):
            if self.alive[p]:
                self.scores[p] = ((self.step_count + 1) * MAX_LEN_SCORE
                                  + len(self.geese[p]))

    def _spawn_food(self):
        occupied = set(self.food)
        for g in self.geese:
            occupied.update(g)
        free = [c for c in range(N_CELLS) if c not in occupied]
        while len(self.food) < N_FOOD and free:
            cell = self.rng.choice(free)
            free.remove(cell)
            self.food.append(cell)

    # -- transitions -------------------------------------------------------
    def step(self, actions: Dict[int, Optional[int]]):
        """Canonical kaggle resolution order (see the rules-source note in
        docs/geese_rules.md): per agent — reversal death (unconditional, even
        at length 1), move + eat-or-pop-tail, SELF-collision against the
        remaining own cells (old head still present, popped tail absent, new
        head not yet inserted), head insert, hunger pop + starvation death —
        then ONE simultaneous cross-goose pass: a histogram over every cell
        of every surviving goose kills any goose whose head cell counts > 1.
        Geese emptied in the per-agent phase (reversed / self-collided /
        starved) contribute nothing to the histogram, so their vacated cells
        are safe to enter the same step."""
        self.prev_geese = [list(g) for g in self.geese]
        self.step_count += 1
        acted: Dict[int, int] = {}
        hungry = self.step_count % HUNGER_RATE == 0

        # per-agent phase
        for p in range(self.NUM_AGENTS):
            if not self.alive[p]:
                continue
            action = actions.get(p)
            action = 0 if action is None else int(action)
            acted[p] = action
            goose = self.geese[p]
            if (p in self.last_actions
                    and action == OPPOSITE[self.last_actions[p]]):
                self.alive[p] = False      # reversal: dies at ANY length
                self.geese[p] = []
                continue
            head = _move(goose[0], action)
            if head in self.food:
                self.food.remove(head)     # grow: keep the tail
            else:
                goose.pop()
            if head in goose:              # self collision (pre-insert)
                self.alive[p] = False
                self.geese[p] = []
                continue
            goose.insert(0, head)
            if hungry:
                goose.pop()
                if not goose:
                    self.alive[p] = False  # starved

        # simultaneous cross-goose collisions
        count: Dict[int, int] = {}
        for p in range(self.NUM_AGENTS):
            for cell in self.geese[p]:
                count[cell] = count.get(cell, 0) + 1
        for p in range(self.NUM_AGENTS):
            if not self.alive[p] or not self.geese[p]:
                continue
            if count[self.geese[p][0]] > 1:
                self.alive[p] = False
                self.geese[p] = []

        for p, a in acted.items():
            self.last_actions[p] = a
        self._spawn_food()
        self._update_scores()

    # -- protocol ----------------------------------------------------------
    def turns(self) -> List[int]:
        return [p for p in self.players() if self.alive[p]]

    def terminal(self) -> bool:
        return sum(self.alive) <= 1 or self.step_count >= MAX_STEPS

    def outcome(self) -> Dict[int, float]:
        """Pairwise-rank score: +1/(N-1) per beaten opponent, -1/(N-1) per
        opponent that beat you."""
        outcomes = {p: 0.0 for p in self.players()}
        for p in self.players():
            for q in self.players():
                if p == q:
                    continue
                if self.scores[p] > self.scores[q]:
                    outcomes[p] += 1 / (self.NUM_AGENTS - 1)
                elif self.scores[p] < self.scores[q]:
                    outcomes[p] -= 1 / (self.NUM_AGENTS - 1)
        return outcomes

    def legal_actions(self, player: Optional[int] = None) -> List[int]:
        return list(range(len(ACTIONS)))

    def players(self) -> List[int]:
        return list(range(self.NUM_AGENTS))

    def action2str(self, a: int, player: Optional[int] = None) -> str:
        return ACTIONS[a]

    def str2action(self, s: str, player: Optional[int] = None) -> int:
        return ACTIONS.index(s)

    # -- delta sync --------------------------------------------------------
    def diff_info(self, player: Optional[int] = None):
        return {
            'geese': [list(g) for g in self.geese],
            'prev_geese': [list(g) for g in self.prev_geese],
            'food': list(self.food),
            'alive': list(self.alive),
            'scores': list(self.scores),
            'last_actions': dict(self.last_actions),
            'step': self.step_count,
        }

    def update(self, info, reset: bool):
        self.geese = [list(g) for g in info['geese']]
        self.prev_geese = [list(g) for g in info['prev_geese']]
        self.food = list(info['food'])
        self.alive = list(info['alive'])
        self.scores = list(info['scores'])
        self.last_actions = dict(info['last_actions'])
        self.step_count = info['step']

    # -- observation -------------------------------------------------------
    def observation(self, player: Optional[int] = None) -> np.ndarray:
        if player is None:
            player = 0
        b = np.zeros((self.NUM_AGENTS * 4 + 1, N_CELLS), dtype=np.float32)
        for p, goose in enumerate(self.geese):
            ch = (p - player) % self.NUM_AGENTS
            for cell in goose[:1]:
                b[0 + ch, cell] = 1
            for cell in goose[-1:]:
                b[4 + ch, cell] = 1
            for cell in goose:
                b[8 + ch, cell] = 1
        for p, goose in enumerate(self.prev_geese):
            ch = (p - player) % self.NUM_AGENTS
            for cell in goose[:1]:
                b[12 + ch, cell] = 1
        for cell in self.food:
            b[16, cell] = 1
        return b.reshape(-1, R, C)

    # -- rule-based opponent ----------------------------------------------
    def rule_based_action(self, player: int, key=None) -> int:
        """Behavioral port of kaggle_environments' GreedyAgent, which the
        reference delegates to (reference hungry_geese.py:189-197).

        Decision rules, in the kaggle agent's own terms: a candidate move
        may not land on a cell adjacent to any opponent head, on any
        non-tail goose cell (a tail vacates this turn and IS steppable), on
        the tail of an opponent whose head is adjacent to food (about to
        eat and keep that tail), and may not reverse the player's last
        action. Among candidates it picks the minimum
        *non-wrapped* Manhattan distance to the nearest food (the kaggle
        agent does not wrap its distance metric), ties broken in its
        Action-enum iteration order NORTH, EAST, SOUTH, WEST. If no
        candidate survives, it plays uniformly at random over all four
        actions (even a fatal one)."""
        goose = self.geese[player]
        if not goose:
            return 0
        head = goose[0]

        opponents = [g for p, g in enumerate(self.geese) if p != player and g]
        head_adjacent = {_move(g[0], a) for g in opponents for a in range(4)}
        # kaggle's bodies EXCLUDE tails (goose[0:-1] — a tail cell vacates
        # this turn), then add back the tails of opponents about to eat
        bodies = {cell for g in self.geese for cell in g[:-1]}
        eating_tails = {g[-1] for g in opponents
                        if any(_move(g[0], a) in self.food for a in range(4))}
        last = self.last_actions.get(player)
        banned = OPPOSITE[last] if last is not None else None

        def food_steps(cell: int) -> int:
            x, y = divmod(cell, C)
            return min((abs(x - fx) + abs(y - fy)
                        for f in self.food for fx, fy in [divmod(f, C)]),
                       default=0)

        best = None
        for a in GREEDY_ACTION_ORDER:
            to = _move(head, a)
            if (a == banned or to in head_adjacent or to in bodies
                    or to in eating_tails):
                continue
            d = food_steps(to)
            if best is None or d < best[0]:
                best = (d, a)
        if best is None:
            return self.rng.randrange(4)
        return best[1]

    def net(self):
        """The port's GeeseNet; env_args ``torus_impl`` picks the trunk
        ('pallas' = the fused CUDA kernel, 'pad' / 'halo' = plain torch
        convs). Only GroupNorm and the feed-forward net are ported."""
        from ...models.geese import GeeseNet
        if self.args.get('net_kind', 'conv') != 'conv':
            raise ValueError('net_kind %r is not ported yet'
                             % self.args['net_kind'])
        return GeeseNet(norm_kind=self.args.get('norm_kind', 'group'),
                        torus_impl=self.args.get('torus_impl', 'pad'))

    def __str__(self) -> str:
        grid = [['.'] * C for _ in range(R)]
        for cell in self.food:
            x, y = divmod(cell, C)
            grid[x][y] = 'f'
        for p, goose in enumerate(self.geese):
            for i, cell in enumerate(goose):
                x, y = divmod(cell, C)
                grid[x][y] = str(p) if i == 0 else 'abcd'[p]
        lines = ['step %d  alive %s' % (self.step_count, self.alive)]
        lines += [''.join(row) for row in grid]
        lines.append(' '.join(str(len(g) or '-') for g in self.geese))
        return '\n'.join(lines)


if __name__ == '__main__':
    e = Environment()
    for _ in range(10):
        e.reset()
        while not e.terminal():
            e.step({p: random.choice(e.legal_actions(p)) for p in e.turns()})
        print(e)
        print(e.outcome())
