"""The update step's benchmark: ``python -m handyrl_tpu_torch.bench``.

The port's counterpart of the root ``bench.py``'s default mode (which stays
the JAX package's): the headline step, GeeseNet at full width (filters 32,
12 blocks, ``torus_impl='pallas'``, fp32) on a synthetic batch of B=128
trajectories of T=16 steps, TD/TD targets, ``observation=True``,
``turn_based_training=False``, gamma 0.99. It runs warm-up steps, then
``--steps`` timed steps, and prints one JSON line: trajectories per second,
the step time, the card, the final losses, and every kernel's launch count
over all the steps it ran (the counts are set to 0 just before the first).

Runs on ``--device cuda`` (the default; without a card it raises), where it
times the step in both forms, eager and as one CUDA graph (the line's
``value`` and ``step_ms`` are the graphed step's, ``eager_step_ms`` the
eager one's; see :func:`run_bench`), or, when asked, ``--device cpu``,
where the eager step alone runs on the kernels' plain versions and no
launch is counted.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .model import resolve_device
from .models.geese import GeeseNet
from .ops import kernel_launches, reset_kernel_launches
from .ops.losses import LossConfig
from .ops.train_step import (GRAPH_WARMUP_STEPS, TrainState,
                              build_graphed_update_step, build_update_step,
                              init_train_state)

METRIC = 'learner trajectories/sec (GeeseNet B=128 T=16, full update step)'
UNIT = 'trajectories/sec'
LR = 1e-5
WARMUP = 3
SEED = 0


def synthetic_batch(B, T, P, obs_shape, n_actions, rng) -> Dict[str, np.ndarray]:
    """A structurally valid (B,T,P,...) training batch (solo-training mode:
    P=1 everywhere, all masks on). A copy of the JAX package's
    ``__graft_entry__._synthetic_batch``: the same draws in the same order,
    so one seed gives both packages the same batch."""
    ones = np.ones((B, T, P, 1), np.float32)
    amask = np.zeros((B, T, P, n_actions), np.float32)
    return {
        'observation': rng.rand(B, T, P, *obs_shape).astype(np.float32),
        'selected_prob': np.full((B, T, P, 1), 1.0 / n_actions, np.float32),
        'value': rng.uniform(-1, 1, (B, T, P, 1)).astype(np.float32),
        'action': rng.randint(0, n_actions, (B, T, P, 1)).astype(np.int32),
        'outcome': np.sign(rng.randn(B, 1, P, 1)).astype(np.float32),
        'reward': np.zeros((B, T, P, 1), np.float32),
        'return': rng.uniform(-1, 1, (B, T, P, 1)).astype(np.float32),
        'episode_mask': ones.copy(),
        'turn_mask': ones.copy(),
        'observation_mask': ones.copy(),
        'action_mask': amask,
        'progress': np.linspace(0, 1, T, dtype=np.float32)[None, :, None]
        .repeat(B, 0),
    }


def headline_setup(device: Any = 'cuda', B: int = 128, T: int = 16,
                   filters: int = 32, layers: int = 12,
                   policy_target: str = 'TD', value_target: str = 'TD'
                   ) -> Tuple[GeeseNet, LossConfig, Dict[str, torch.Tensor],
                              TrainState]:
    """(net, cfg, batch, state) of the headline step on ``device``: weights
    from a seeded torch generator, the batch from a seeded numpy one."""
    dev = resolve_device(device)
    net = GeeseNet(filters=filters, layers=layers, torus_impl='pallas',
                   generator=torch.Generator().manual_seed(SEED)).to(dev)
    batch = synthetic_batch(B, T, 1, (17, 7, 11), 4,
                            np.random.RandomState(SEED))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    cfg = LossConfig(turn_based_training=False, observation=True,
                     policy_target=policy_target, value_target=value_target,
                     gamma=0.99)
    return net, cfg, batch, init_train_state(net)


def _time_steps(step, warmup: int, steps: int):
    """Runs ``step()`` ``warmup`` then ``steps`` times; returns (seconds of
    the timed steps, their last metrics as floats). Each run ends in a
    read of the metrics, which waits for the device."""
    for _ in range(warmup):
        metrics = step()
    float(metrics['total'])           # waits for the warm-up steps
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step()
    final = {k: float(v) for k, v in metrics.items()}   # waits for them all
    return time.perf_counter() - t0, final


def run_bench(device: Any = 'cuda', steps: int = 30, B: int = 128,
              T: int = 16, filters: int = 32, layers: int = 12
              ) -> Dict[str, Any]:
    """Time the TD/TD update step; returns the result line as a dict.

    On the card it times both forms from the same initial state, eager
    (:func:`build_update_step`) and then graphed
    (:func:`build_graphed_update_step`): ``value`` and ``step_ms`` are the
    graphed step's, the counterpart of the JAX bench's jitted step, and
    ``eager_step_ms`` stands beside them. On the CPU, where a CUDA graph
    does not exist, the eager step alone runs: ``value`` and ``step_ms``
    are its, and ``eager_step_ms`` and every graphed field are None.
    ``form`` names the form ``value`` times. The graphed form's first call
    runs GRAPH_WARMUP_STEPS eager steps of its body (their state changes
    undone) and the capture; ``graph_first_call_ms`` times that call, and
    its warm-up steps are in ``steps_by_form`` and the launch counts."""
    dev = resolve_device(device)
    if dev.type == 'cuda':
        # fp32 means fp32: no TF32 in the heads' and losses' matmuls
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    net, cfg, batch, state = headline_setup(dev, B, T, filters, layers)
    lr = torch.tensor(LR, device=dev)
    forms = ['eager'] + (['graphed'] if dev.type == 'cuda' else [])
    seconds, finals, launches, peak_mib, runs = {}, {}, {}, {}, {}
    first_call_ms = None
    reset_kernel_launches()
    for form in forms:
        before = kernel_launches()
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        runs[form] = {'warmup': WARMUP, 'timed': steps, 'run': WARMUP + steps}
        if form == 'eager':
            update = build_update_step(net, cfg)
            holder = {'state': init_train_state(net)}

            def step():
                holder['state'], metrics = update(holder['state'], batch, lr)
                return metrics
            warmup = WARMUP
        else:
            graphed = build_graphed_update_step(net, cfg,
                                                init_train_state(net))
            t0 = time.perf_counter()
            float(graphed(batch, lr)['total'])  # its warm-up, capture, replay
            first_call_ms = 1e3 * (time.perf_counter() - t0)
            runs[form]['capture_warmup'] = GRAPH_WARMUP_STEPS
            runs[form]['run'] += GRAPH_WARMUP_STEPS

            def step():
                return graphed(batch, lr)
            warmup = WARMUP - 1
        seconds[form], finals[form] = _time_steps(step, warmup, steps)
        after = kernel_launches()
        launches[form] = {k: after[k] - before[k] for k in after}
        if dev.type == 'cuda':
            peak_mib[form] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    form = forms[-1]
    final = finals[form]
    step_s = seconds[form] / max(1, steps)
    on_card = dev.type == 'cuda'
    return {
        'metric': METRIC, 'value': B / step_s, 'unit': UNIT,
        'step_ms': 1e3 * step_s, 'form': form,
        'eager_step_ms': (1e3 * seconds['eager'] / max(1, steps)
                          if on_card else None),
        'graph_first_call_ms': first_call_ms,
        'peak_memory_mib': peak_mib or None,
        'device': (torch.cuda.get_device_name(dev) if dev.type == 'cuda'
                   else 'cpu'),
        'compute_dtype': 'float32',
        'config': {'B': B, 'T': T, 'filters': filters, 'layers': layers,
                   'policy_target': cfg.policy_target,
                   'value_target': cfg.value_target, 'lr': LR},
        'losses': {k: final[k] for k in ('total', 'p', 'v', 'ent')},
        'grad_norm': final['diag_grad_norm'],
        'nonfinite': final['nonfinite'],
        'steps_run': sum(r['run'] for r in runs.values()),
        'timed_steps': steps,
        'steps_by_form': runs if on_card else None,
        'kernel_launches': kernel_launches(),
        'kernel_launches_by_form': launches if on_card else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m handyrl_tpu_torch.bench',
        description='time the GeeseNet update step of handyrl_tpu_torch')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--steps', type=int, default=30,
                    help='timed steps (after %d warm-up steps)' % WARMUP)
    a = ap.parse_args(argv)
    print(json.dumps(run_bench(a.device, a.steps)), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
