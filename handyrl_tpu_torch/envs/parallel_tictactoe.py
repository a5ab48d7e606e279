"""Simultaneous-move Tic-Tac-Toe variant.

Copy of ``handyrl_tpu/envs/parallel_tictactoe.py`` on the port's
``envs/tictactoe.py``: both players act each step and the environment
applies one of the submitted actions, drawn with Python's ``random`` as
the JAX package's copy draws it; each seat observes from its own colour,
and the game also ends on a full board (a cell may be overwritten).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from .tictactoe import Environment as TicTacToe, WIN_LINES, COLS, ROWS, GLYPH


class Environment(TicTacToe):

    def step(self, actions: Dict[int, Optional[int]]):
        player = random.choice(list(actions.keys()))
        self._apply(actions[player], player)

    def _apply(self, action: int, player: int):
        color = [self.BLACK, self.WHITE][player]
        self.cells[action] = color
        line_sums = self.cells[WIN_LINES].sum(axis=1)
        if (line_sums == 3 * color).any():
            self.winner = color
        self.moves.append((color, action))

    def turn(self):
        raise NotImplementedError()

    def turns(self) -> List[int]:
        return self.players()

    def terminal(self) -> bool:
        # a cell may be overwritten, so the game also ends when the board fills
        return self.winner != 0 or not (self.cells == 0).any()

    def diff_info(self, player: Optional[int] = None) -> str:
        if not self.moves:
            return ''
        color, action = self.moves[-1]
        return self.action2str(action) + ':' + GLYPH[color]

    def update(self, info: str, reset: bool):
        if reset:
            self.reset()
        else:
            move, glyph = info.split(':')
            self._apply(self.str2action(move), 'OX'.index(glyph))

    def observation(self, player: Optional[int] = None) -> np.ndarray:
        # simultaneous game: every player observes from their own color
        me = self.BLACK if (player is None or player == 0) else self.WHITE
        board = self.cells.reshape(3, 3)
        return np.stack([
            np.ones((3, 3)),
            (board == me).astype(np.float32),
            (board == -me).astype(np.float32),
        ]).astype(np.float32)

    def __str__(self) -> str:
        board = self.cells.reshape(3, 3)
        lines = ['  ' + ' '.join(ROWS)]
        for i in range(3):
            lines.append(COLS[i] + ' ' + ' '.join(GLYPH[int(v)] for v in board[i]))
        return '\n'.join(lines)


if __name__ == '__main__':
    e = Environment()
    for _ in range(10):
        e.reset()
        while not e.terminal():
            e.step({p: random.choice(e.legal_actions(p)) for p in e.turns()})
        print(e)
        print(e.outcome())
