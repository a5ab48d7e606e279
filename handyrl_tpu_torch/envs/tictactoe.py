"""Tic-Tac-Toe environment.

Copy of ``handyrl_tpu/envs/tictactoe.py`` with ``net()`` returning the
port's SimpleConv2dModel; the tests hold it to the JAX package's copy move
for move. 2-player turn-based perfect-information play on a 3x3 board,
actions 0..8, observation planes (3,3,3) from the side-to-move's view,
string moves like "A1", delta sync via the last move. Wins are read from
precomputed winning lines.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from ..environment import BaseEnvironment

# The eight winning triplets of board cells (rows, columns, diagonals).
WIN_LINES = np.array([
    [0, 1, 2], [3, 4, 5], [6, 7, 8],   # rows
    [0, 3, 6], [1, 4, 7], [2, 5, 8],   # columns
    [0, 4, 8], [2, 4, 6],              # diagonals
], dtype=np.int64)

COLS = 'ABC'
ROWS = '123'
GLYPH = {0: '_', 1: 'O', -1: 'X'}


class Environment(BaseEnvironment):
    BLACK, WHITE = 1, -1

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        self.reset()

    def reset(self, args: Optional[dict] = None):
        # cells: flat length-9 vector, +1 black / -1 white / 0 empty
        self.cells = np.zeros(9, dtype=np.int8)
        self.side = self.BLACK
        self.winner = 0
        self.moves: List[int] = []

    # -- transitions ------------------------------------------------------
    def play(self, action: int, player: Optional[int] = None):
        self.cells[action] = self.side
        line_sums = self.cells[WIN_LINES].sum(axis=1)
        if (line_sums == 3 * self.side).any():
            self.winner = self.side
        self.side = -self.side
        self.moves.append(action)

    def turn(self) -> int:
        return len(self.moves) % 2

    def terminal(self) -> bool:
        return self.winner != 0 or len(self.moves) == 9

    def outcome(self) -> Dict[int, float]:
        score = float(self.winner)
        return {0: score, 1: -score}

    def legal_actions(self, player: Optional[int] = None) -> List[int]:
        return np.flatnonzero(self.cells == 0).tolist()

    def players(self) -> List[int]:
        return [0, 1]

    def reward(self) -> Dict[int, float]:
        return {}

    # -- observation ------------------------------------------------------
    def observation(self, player: Optional[int] = None) -> np.ndarray:
        """Planes: [is-my-turn-view, my stones, opponent stones], (3, 3, 3)."""
        turn_view = player is None or player == self.turn()
        me = self.side if turn_view else -self.side
        board = self.cells.reshape(3, 3)
        return np.stack([
            np.full((3, 3), 1.0 if turn_view else 0.0),
            (board == me).astype(np.float32),
            (board == -me).astype(np.float32),
        ]).astype(np.float32)

    # -- string codec ------------------------------------------------------
    def action2str(self, a: int, player: Optional[int] = None) -> str:
        return COLS[a // 3] + ROWS[a % 3]

    def str2action(self, s: str, player: Optional[int] = None) -> int:
        return COLS.index(s[0]) * 3 + ROWS.index(s[1])

    def diff_info(self, player: Optional[int] = None) -> str:
        return self.action2str(self.moves[-1]) if self.moves else ''

    def update(self, info: str, reset: bool):
        if reset:
            self.reset()
        else:
            self.play(self.str2action(info))

    def __str__(self) -> str:
        board = self.cells.reshape(3, 3)
        lines = ['  ' + ' '.join(ROWS)]
        for i in range(3):
            lines.append(COLS[i] + ' ' + ' '.join(GLYPH[int(v)] for v in board[i]))
        lines.append('record = ' + ' '.join(self.action2str(a) for a in self.moves))
        return '\n'.join(lines)

    # -- model hook --------------------------------------------------------
    def net(self):
        """The port's SimpleConv2dModel at its one width (filters 32, 3
        blocks)."""
        from ..models.tictactoe import SimpleConv2dModel
        return SimpleConv2dModel()


if __name__ == '__main__':
    e = Environment()
    for _ in range(10):
        e.reset()
        while not e.terminal():
            e.play(random.choice(e.legal_actions()))
        print(e)
        print(e.outcome())
