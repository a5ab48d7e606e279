"""ConnectX (Connect Four) policy/value net.

The port of ``handyrl_tpu/models/connect_four.py:ConnectFourNet``: the
TicTacToe net's family on the (3, 6, 7) plane codec, a 3->F zero-padded
3x3 stem conv (with bias) and ``layers`` conv + GroupNorm blocks, each
followed by a ReLU, then a 7-way column policy head and a tanh value head
over the 42 cells. PyTorch's convs throughout: the JAX package leaves this
net to XLA (no TPU kernel). Its snapshot format is SimpleConv2dModel's
(the same flax tree at 4 blocks).
"""

from __future__ import annotations

from . import register
from .tictactoe import SimpleConv2dModel, params_from_flax, params_to_flax

__all__ = ['ConnectFourNet', 'params_from_flax', 'params_to_flax']


@register('ConnectFourNet')
class ConnectFourNet(SimpleConv2dModel):
    DEFAULTS = {'filters': 32, 'layers': 4}
    ROWS, COLS, ACTIONS = 6, 7, 7
