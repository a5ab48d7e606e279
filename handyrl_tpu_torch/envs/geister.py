"""Geister: 2-player imperfect-information board game.

Copy of ``handyrl_tpu/envs/geister.py`` with ``net()`` returning the port's
GeisterNet; the tests hold it to the JAX package's copy move for move (it
draws from Python's ``random`` exactly where that one does, so a seeded
game is the same game in both). 6x6 board, each side secretly assigns 4
blue (good) and 4 red (bad) ghosts to 8 fixed home squares (70 possible
layouts, action ids 144..213), then alternates single-square orthogonal
moves (action ids 0..143 = direction*36 + from-square, always encoded from
the mover's own rotated perspective). Capturing all of the opponent's
blues or losing all your reds loses for them; a blue ghost may escape
through the opponent's two corner goal cells; 200 plies is a draw.
Per-step reward -0.01 for both players. Observations hide the opponent's
piece types and are rotated 180 degrees for the second player.

The delta-sync protocol ('set' layout or -1 for the hidden opponent
layout, 'move' strings, 'captured' type disclosure to the capturing
player) lets a mirror env follow a game: it assigns random types to
unseen opponent pieces and corrects squares when captures reveal them.
"""

from __future__ import annotations

import itertools
import random
from typing import Dict, List, Optional

import numpy as np

from ..environment import BaseEnvironment

ROWS, COLS = 'ABCDEF', '123456'
BLUE, RED = 0, 1
TYPE_CHARS = 'BR'
GLYPHS = {-1: '_', 0: 'B', 1: 'R', 2: 'b', 3: 'r', 4: '*'}

# orthogonal step offsets, index = action direction for the BLACK perspective
STEPS = np.array([(-1, 0), (0, -1), (0, 1), (1, 0)], dtype=np.int32)

# home squares per color, in layout-slot order
HOME_SQUARES = [
    ['B2', 'C2', 'D2', 'E2', 'B1', 'C1', 'D1', 'E1'],   # first player (black)
    ['E5', 'D5', 'C5', 'B5', 'E6', 'D6', 'C6', 'B6'],   # second player (white)
]

# goal (escape) cells just off the board, per color
GOALS = np.array([[(-1, 5), (6, 5)], [(-1, 0), (6, 0)]], dtype=np.int32)

# the 70 ways to pick which 4 of the 8 home slots hold blue ghosts
LAYOUTS = list(itertools.combinations(range(8), 4))

N_MOVE_ACTIONS = 4 * 36
N_SET_ACTIONS = len(LAYOUTS)


def piece_of(color: int, ptype: int) -> int:
    return color * 2 + ptype


def color_of(piece: int) -> int:
    return -1 if piece < 0 else piece // 2


def type_of(piece: int) -> int:
    return -1 if piece < 0 else piece % 2


class Environment(BaseEnvironment):

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        self.args = args or {}
        self.reset()

    def reset(self, args: Optional[dict] = None):
        self.board = np.full((6, 6), -1, dtype=np.int32)
        self.color = 0                   # 0 = first player (black), to move
        self.turn_count = -2             # two setup plies before ply 0
        self.win_color: Optional[int] = None   # 0/1 winner, 2 draw
        self.counts = np.zeros(4, dtype=np.int32)      # alive per piece kind
        # per piece-slot (color*8+slot): current square or (-1,-1) if gone
        self.slot_pos = np.full((16, 2), -1, dtype=np.int32)
        # board -> slot index for O(1) capture bookkeeping
        self.slot_at = np.full((6, 6), -1, dtype=np.int32)
        self.moves: List[int] = []
        self.captured_type: Optional[int] = None
        self.layouts: Dict[int, int] = {}

    # -- geometry helpers --------------------------------------------------
    @staticmethod
    def _onboard(pos) -> bool:
        return 0 <= pos[0] < 6 and 0 <= pos[1] < 6

    @staticmethod
    def _rot(pos):
        return np.array((5 - pos[0], 5 - pos[1]), dtype=np.int32)

    def _is_goal(self, color: int, pos) -> bool:
        return any(g[0] == pos[0] and g[1] == pos[1] for g in GOALS[color])

    # -- square <-> string -------------------------------------------------
    @staticmethod
    def _sq2str(pos) -> str:
        if 0 <= pos[0] < 6 and 0 <= pos[1] < 6:
            return ROWS[pos[0]] + COLS[pos[1]]
        return '**'

    @staticmethod
    def _str2sq(s: str):
        if s == '**':
            return None
        return np.array((ROWS.find(s[0]), COLS.find(s[1])), dtype=np.int32)

    # -- action codec (mover-perspective encoding) ------------------------
    def _encode_move(self, pos_from, direction: int, color: int) -> int:
        if color == 1:
            pos_from = self._rot(pos_from)
            direction = 3 - direction
        return direction * 36 + pos_from[0] * 6 + pos_from[1]

    def _move_from(self, action: int, color: int):
        sq = action % 36
        pos = np.array((sq // 6, sq % 6), dtype=np.int32)
        return self._rot(pos) if color == 1 else pos

    def _move_dir(self, action: int, color: int) -> int:
        d = action // 36
        return 3 - d if color == 1 else d

    def _move_to(self, action: int, color: int):
        return self._move_from(action, color) + STEPS[self._move_dir(action, color)]

    def action2str(self, a: int, player: Optional[int] = None) -> str:
        if a >= N_MOVE_ACTIONS:
            return 's%d' % (a - N_MOVE_ACTIONS)
        c = player
        return (self._sq2str(self._move_from(a, c))
                + self._sq2str(self._move_to(a, c)))

    def str2action(self, s: str, player: Optional[int] = None) -> int:
        if s[0] == 's':
            return N_MOVE_ACTIONS + int(s[1:])
        c = player
        pos_from = self._str2sq(s[:2])
        pos_to = self._str2sq(s[2:])
        if pos_to is None:
            # an escape move: find the adjacent goal cell
            for g in GOALS[c]:
                if int(((pos_from - g) ** 2).sum()) == 1:
                    diff = g - pos_from
                    break
        else:
            diff = pos_to - pos_from
        direction = next(d for d, dd in enumerate(STEPS)
                         if dd[0] == diff[0] and dd[1] == diff[1])
        return self._encode_move(pos_from, direction, c)

    # -- piece bookkeeping -------------------------------------------------
    def _place(self, piece: int, pos, slot: int):
        self.board[pos[0], pos[1]] = piece
        self.slot_pos[slot] = pos
        self.slot_at[pos[0], pos[1]] = slot
        self.counts[piece] += 1

    def _remove(self, pos):
        piece = self.board[pos[0], pos[1]]
        slot = self.slot_at[pos[0], pos[1]]
        self.board[pos[0], pos[1]] = -1
        self.slot_at[pos[0], pos[1]] = -1
        self.slot_pos[slot] = (-1, -1)
        self.counts[piece] -= 1
        return piece

    def _relocate(self, pos_from, pos_to):
        piece = self.board[pos_from[0], pos_from[1]]
        slot = self.slot_at[pos_from[0], pos_from[1]]
        self.board[pos_from[0], pos_from[1]] = -1
        self.slot_at[pos_from[0], pos_from[1]] = -1
        self.board[pos_to[0], pos_to[1]] = piece
        self.slot_at[pos_to[0], pos_to[1]] = slot
        self.slot_pos[slot] = pos_to

    # -- transitions -------------------------------------------------------
    def _apply_layout(self, layout: int):
        self.layouts[self.color] = layout
        if layout < 0:
            layout = random.randrange(N_SET_ACTIONS)   # hidden opponent setup
        blue_slots = set(LAYOUTS[layout])
        for slot in range(8):
            ptype = BLUE if slot in blue_slots else RED
            pos = self._str2sq(HOME_SQUARES[self.color][slot])
            self._place(piece_of(self.color, ptype), pos, self.color * 8 + slot)
        self.color = 1 - self.color
        self.turn_count += 1

    def play(self, action: int, player: Optional[int] = None):
        if self.turn_count < 0:
            return self._apply_layout(action - N_MOVE_ACTIONS)

        pos_from = self._move_from(action, self.color)
        pos_to = self._move_to(action, self.color)
        self.captured_type = None

        if not self._onboard(pos_to):
            # blue ghost escapes: mover wins
            self._remove(pos_from)
            self.win_color = self.color
        else:
            target = self.board[pos_to[0], pos_to[1]]
            if target != -1:
                captured = self._remove(pos_to)
                self.captured_type = type_of(captured)
                if self.counts[captured] == 0:
                    if type_of(captured) == BLUE:
                        # took every opponent blue: mover wins
                        self.win_color = self.color
                    else:
                        # took every opponent red: mover loses
                        self.win_color = 1 - self.color
            self._relocate(pos_from, pos_to)

        self.color = 1 - self.color
        self.turn_count += 1
        self.moves.append(action)

        if self.turn_count >= 200 and self.win_color is None:
            self.win_color = 2   # draw

    # -- protocol ----------------------------------------------------------
    def turn(self) -> int:
        return self.players()[self.turn_count % 2]

    def terminal(self) -> bool:
        return self.win_color is not None

    def reward(self) -> Dict[int, float]:
        return {p: -0.01 for p in self.players()}

    def outcome(self) -> Dict[int, float]:
        scores = [0.0, 0.0]
        if self.win_color == 0:
            scores = [1.0, -1.0]
        elif self.win_color == 1:
            scores = [-1.0, 1.0]
        return {p: scores[i] for i, p in enumerate(self.players())}

    def legal_actions(self, player: Optional[int] = None) -> List[int]:
        if self.turn_count < 0:
            return [N_MOVE_ACTIONS + i for i in range(N_SET_ACTIONS)]
        actions = []
        c = self.color
        for slot in range(c * 8, (c + 1) * 8):
            pos = self.slot_pos[slot]
            if pos[0] < 0:
                continue
            ptype = type_of(self.board[pos[0], pos[1]])
            for d in range(4):
                to = pos + STEPS[d]
                if self._onboard(to):
                    if color_of(self.board[to[0], to[1]]) == c:
                        continue   # own piece in the way
                elif not (ptype == BLUE and self._is_goal(c, to)):
                    continue       # only blues may escape, only via goals
                actions.append(self._encode_move(pos, d, c))
        return actions

    def players(self) -> List[int]:
        return [0, 1]

    # -- delta sync (network battle / mirror envs) ------------------------
    def diff_info(self, player: Optional[int] = None):
        color = player
        mover = (self.turn_count - 1) % 2
        info: Dict[str, object] = {}
        if not self.moves:
            if self.turn_count > -2:
                info['set'] = self.layouts[mover] if color == mover else -1
        else:
            info['move'] = self.action2str(self.moves[-1], mover)
            if color == mover and self.captured_type is not None:
                info['captured'] = TYPE_CHARS[self.captured_type]
        return info

    def update(self, info, reset: bool):
        if reset:
            self.reset(info if isinstance(info, dict) else None)
        elif 'set' in info:
            self._apply_layout(info['set'])
        elif 'move' in info:
            action = self.str2action(info['move'], self.color)
            if 'captured' in info:
                # the capture reveals the true type: fix the square first
                pos_to = self._move_to(action, self.color)
                t = TYPE_CHARS.index(info['captured'])
                wrong = self.board[pos_to[0], pos_to[1]]
                actual = piece_of(1 - self.color, t)
                self.counts[wrong] -= 1
                self.counts[actual] += 1
                self.board[pos_to[0], pos_to[1]] = actual
            self.play(action)

    # -- observation -------------------------------------------------------
    def observation(self, player: Optional[int] = None):
        """Dict obs {scalar(18), board(7,6,6)} from the viewer's own
        perspective; opponent piece types are hidden unless player is None
        (the omniscient view). Second player sees the board rotated 180."""
        turn_view = player is None or player == self.turn()
        color = self.color if turn_view else 1 - self.color
        opp = 1 - color

        n_my_blue = self.counts[piece_of(color, BLUE)]
        n_my_red = self.counts[piece_of(color, RED)]
        n_op_blue = self.counts[piece_of(opp, BLUE)]
        n_op_red = self.counts[piece_of(opp, RED)]

        scalar = np.array([
            1 if color == 0 else 0,
            1 if turn_view else 0,
            *[1 if n_my_blue == i else 0 for i in range(1, 5)],
            *[1 if n_my_red == i else 0 for i in range(1, 5)],
            *[1 if n_op_blue == i else 0 for i in range(1, 5)],
            *[1 if n_op_red == i else 0 for i in range(1, 5)],
        ], dtype=np.float32)

        my_blue = self.board == piece_of(color, BLUE)
        my_red = self.board == piece_of(color, RED)
        op_blue = self.board == piece_of(opp, BLUE)
        op_red = self.board == piece_of(opp, RED)
        hidden = player is not None
        zeros = np.zeros_like(self.board, dtype=bool)

        planes = np.stack([
            np.ones((6, 6)),
            my_blue + my_red,
            op_blue + op_red,
            my_blue,
            my_red,
            zeros if hidden else op_blue,
            zeros if hidden else op_red,
        ]).astype(np.float32)

        if color == 1:
            planes = np.rot90(planes, k=2, axes=(1, 2))
        return {'scalar': scalar, 'board': planes}

    def net(self):
        """The port's GeisterNet with the env_args knobs ``norm_kind``,
        ``policy_head`` and ``init_kind`` (the JAX env reads the same)."""
        from ..models.geister import GeisterNet
        return GeisterNet(norm_kind=self.args.get('norm_kind', 'group'),
                          policy_head=self.args.get('policy_head', 'dense'),
                          init_kind=self.args.get('init_kind', 'flax'))

    def __str__(self) -> str:
        def glyph(piece):
            if piece == -1:
                return GLYPHS[-1]
            if self.layouts.get(color_of(piece), 0) < 0:
                return GLYPHS[4]
            return GLYPHS[piece]

        lines = ['  ' + ' '.join(COLS)]
        for i in range(6):
            lines.append(ROWS[i] + ' '
                         + ' '.join(glyph(int(self.board[i, j])) for j in range(6)))
        lines.append('remained = B:%d R:%d b:%d r:%d' % tuple(self.counts))
        lines.append('ply = %s to-move = %s'
                     % (str(self.turn_count).ljust(3), 'BW'[self.color]))
        return '\n'.join(lines)


if __name__ == '__main__':
    e = Environment()
    for _ in range(10):
        e.reset()
        while not e.terminal():
            e.play(random.choice(e.legal_actions()))
        print(e)
        print(e.outcome())
