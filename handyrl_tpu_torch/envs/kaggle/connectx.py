"""ConnectX: kaggle's Connect Four on the standard 6x7 board.

Copy of ``handyrl_tpu/envs/kaggle/connectx.py`` with ``net()`` returning
the port's ConnectFourNet; the tests hold it to the JAX package's copy move
for move.

The kaggle competition wraps ``kaggle_environments.make("connectx")``;
that package is not available here, so this module implements the default
configuration natively (rows=6, columns=7, inarow=4) with the framework's
training surface:

  * turn-based perfect information — actions 0..6 drop a checker into a
    column, full columns are illegal; four in a row horizontally,
    vertically or diagonally wins; a full board with no line is a draw;
  * observations are 3 planes (6, 7) from the side-to-move's view
    ([is-my-turn-view, my checkers, opponent checkers]), the same codec
    TicTacToe uses, so the shared conv trunk applies unchanged;
  * ``rule_based_action`` is the classic one-ply heuristic the kaggle
    "negamax-lite" starter agents share: win now if a drop wins, block
    the opponent's immediate win otherwise, else prefer the center
    column (ties broken center-out, deterministically) — a real (if
    shallow) anchor for league rating matches;
  * the string codec is the column number, so network-battle mirrors
    reconstruct the board from one character per ply.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from ...environment import BaseEnvironment

ROWS, COLS = 6, 7
IN_A_ROW = 4
# center-out column preference of the heuristic agent (and a decent
# human-prior ordering for tie-breaks): 3, then 2/4, then 1/5, then 0/6
CENTER_ORDER = [3, 2, 4, 1, 5, 0, 6]
GLYPH = {0: '.', 1: 'O', -1: 'X'}


def _win_lines():
    """Every 4-cell line on the board as an (N, 4) array of flat indices."""
    lines = []
    for r in range(ROWS):
        for c in range(COLS):
            for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
                rr, cc = r + 3 * dr, c + 3 * dc
                if 0 <= rr < ROWS and 0 <= cc < COLS:
                    lines.append([(r + i * dr) * COLS + (c + i * dc)
                                  for i in range(IN_A_ROW)])
    return np.array(lines, dtype=np.int64)


WIN_LINES = _win_lines()


class Environment(BaseEnvironment):
    FIRST, SECOND = 1, -1

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        self.args = args or {}
        self.rng = random.Random(self.args.get('id', 0))
        self.reset()

    def reset(self, args: Optional[dict] = None):
        # cells: flat length-42 vector, +1 first player / -1 second / 0 empty
        self.cells = np.zeros(ROWS * COLS, dtype=np.int8)
        self.side = self.FIRST
        self.winner = 0
        self.moves: List[int] = []

    # -- transitions ------------------------------------------------------
    def _drop_row(self, col: int) -> int:
        """Lowest empty row in ``col`` (-1 when the column is full)."""
        board = self.cells.reshape(ROWS, COLS)
        for r in range(ROWS - 1, -1, -1):
            if board[r, col] == 0:
                return r
        return -1

    def play(self, action: int, player: Optional[int] = None):
        row = self._drop_row(action)
        self.cells[row * COLS + action] = self.side
        line_sums = self.cells[WIN_LINES].sum(axis=1)
        if (line_sums == IN_A_ROW * self.side).any():
            self.winner = self.side
        self.side = -self.side
        self.moves.append(action)

    def turn(self) -> int:
        return len(self.moves) % 2

    def terminal(self) -> bool:
        return self.winner != 0 or len(self.moves) == ROWS * COLS

    def outcome(self) -> Dict[int, float]:
        score = float(self.winner)
        return {0: score, 1: -score}

    def legal_actions(self, player: Optional[int] = None) -> List[int]:
        board = self.cells.reshape(ROWS, COLS)
        return [c for c in range(COLS) if board[0, c] == 0]

    def players(self) -> List[int]:
        return [0, 1]

    # -- observation ------------------------------------------------------
    def observation(self, player: Optional[int] = None) -> np.ndarray:
        """Planes: [is-my-turn-view, my checkers, opponent checkers],
        shape (3, 6, 7) — TicTacToe's codec on the bigger board."""
        turn_view = player is None or player == self.turn()
        me = self.side if turn_view else -self.side
        board = self.cells.reshape(ROWS, COLS)
        return np.stack([
            np.full((ROWS, COLS), 1.0 if turn_view else 0.0),
            (board == me).astype(np.float32),
            (board == -me).astype(np.float32),
        ]).astype(np.float32)

    # -- rule-based opponent ----------------------------------------------
    def rule_based_action(self, player: int, key=None) -> int:
        """One-ply tactical heuristic: play the winning drop if one
        exists, else block the opponent's winning drop, else the first
        legal column center-out — deterministic, so rating matches
        against it are reproducible."""
        legal = self.legal_actions()

        def wins(col: int, side: int) -> bool:
            row = self._drop_row(col)
            idx = row * COLS + col
            self.cells[idx] = side
            won = bool((self.cells[WIN_LINES].sum(axis=1)
                        == IN_A_ROW * side).any())
            self.cells[idx] = 0
            return won

        for side in (self.side, -self.side):   # my win first, then block
            for col in legal:
                if wins(col, side):
                    return col
        for col in CENTER_ORDER:
            if col in legal:
                return col
        return legal[0]

    # -- string codec ------------------------------------------------------
    def action2str(self, a: int, player: Optional[int] = None) -> str:
        return str(a)

    def str2action(self, s: str, player: Optional[int] = None) -> int:
        return int(s)

    def diff_info(self, player: Optional[int] = None) -> str:
        return self.action2str(self.moves[-1]) if self.moves else ''

    def update(self, info: str, reset: bool):
        if reset:
            self.reset()
        else:
            self.play(self.str2action(info))

    def __str__(self) -> str:
        board = self.cells.reshape(ROWS, COLS)
        lines = [' '.join(str(c) for c in range(COLS))]
        for r in range(ROWS):
            lines.append(' '.join(GLYPH[int(v)] for v in board[r]))
        lines.append('record = ' + ' '.join(str(a) for a in self.moves))
        return '\n'.join(lines)

    # -- model hook --------------------------------------------------------
    def net(self):
        """The port's ConnectFourNet at its one width (filters 32, 4
        blocks)."""
        from ...models.connect_four import ConnectFourNet
        return ConnectFourNet()


if __name__ == '__main__':
    e = Environment()
    for _ in range(5):
        e.reset()
        while not e.terminal():
            e.play(random.choice(e.legal_actions()))
        print(e)
        print(e.outcome())
