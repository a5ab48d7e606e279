"""Export a trained model to one self-contained program file (``.pt2``).

The port of ``scripts/export_model.py``'s default mode (handyrl_tpu/
evaluation.py ``ExportedModel`` reads what it writes): where the JAX
package serializes its jitted forward with the Pallas kernel inside as
StableHLO, this traces the port's net with ``torch.export`` and saves the
``ExportedProgram``. The params become part of the program, and a
GeeseNet on ``torus_impl='pallas'`` keeps K1 as one node, the registered
operator ``handyrl_tpu_torch::geese_trunk``. The net is traced in eval
mode under ``torch.no_grad()``, so the trunk takes that operator and not
the training form's autograd function. The input is a batch-1
observation, as the JAX export fixes batch 1. A recurrent net
(``GeeseNetLSTM``, ``net_kind: 'lstm'``) is traced on the observation and
its batch-1 ``init_hidden`` and returns its next hidden state beside
'policy' and 'value', as the JAX export keeps a recurrent net's hidden
inputs and outputs.

``evaluation.ExportedModel`` loads the file with no net class (it imports
only the operator's module) and moves it to the card.

Usage: ``python scripts/torch_export_model.py ENV CKPT_PATH OUT_PATH``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from .environment import make_env

OP_NAME = 'handyrl_tpu_torch::geese_trunk'


def export_env_args(env_name: str, net_kind: str = 'conv'
                    ) -> Dict[str, Any]:
    """The env args an export builds its net from: Hungry Geese's GeeseNet
    takes the kernel trunk (``torus_impl='pallas'``, the same params as
    every other trunk); ``net_kind='lstm'`` builds its GeeseNetLSTM, which
    no trunk kernel fuses."""
    if env_name == 'HungryGeese':
        if net_kind == 'lstm':
            return {'env': env_name, 'net_kind': net_kind}
        return {'env': env_name, 'torus_impl': 'pallas'}
    return {'env': env_name}


def example_observation(env) -> np.ndarray:
    """The first player's observation of a fresh game (the export's
    example input, without the batch axis)."""
    env.reset()
    return np.asarray(env.observation(env.players()[0]), np.float32)


def export_program(module: torch.nn.Module, obs: np.ndarray):
    """``torch.export`` of ``module`` in eval mode, without autograd, on a
    batch-1 ``obs`` (and, for a recurrent module, its batch-1
    ``init_hidden``). Returns the ``ExportedProgram``."""
    module = module.eval()
    x = torch.from_numpy(np.asarray(obs, np.float32)[None]).to(
        next(module.parameters()).device)
    init = getattr(module, 'init_hidden', None)
    hidden = init((1,)) if init is not None else None
    args = (x,) if hidden is None else (x, hidden)
    with torch.no_grad():
        return torch.export.export(module, args)


def program_ops(program) -> list:
    """The names of the operators the program's graph calls."""
    return [str(n.target) for n in program.graph.nodes
            if n.op == 'call_function']


def export_model(env_args: Dict[str, Any], ckpt: str, out_path: str
                 ) -> Dict[str, Any]:
    """Load ``ckpt`` with the port's ``load_model`` (on the CPU), export it
    and save it at ``out_path``. Returns what was written: the path, its
    bytes and whether K1's operator is in the graph."""
    from .evaluation import load_model
    env = make_env(env_args)
    obs = example_observation(env)
    wrapper = load_model(ckpt, env, device='cpu')
    program = export_program(wrapper.module, obs)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)
    return {'path': out_path, 'bytes': os.path.getsize(out_path),
            'kernel_op': any(OP_NAME.replace('::', '.') in name
                             for name in program_ops(program)),
            'obs': obs, 'wrapper': wrapper}
