"""Offline win-rate curve from a model_dir of checkpoints, on the card.

The counterpart of ``scripts/eval_checkpoints.py`` for the PyTorch port:
it scores saved ``<epoch>.ckpt`` files (of either package) with ONE
``DeviceEvaluator`` (``handyrl_tpu_torch/device_generation.py``), whole
matches on the device, one captured rollout graph for every point. Each
checkpoint is loaded in place (``load_state_dict`` copies into the
parameters the graph reads); the matches started under the previous
checkpoint are played out and discarded before a point's games count.

Usage:
  python scripts/torch_eval_checkpoints.py MODEL_DIR ENV OUT.jsonl \\
      [--every N] [--games G] [--envs E] [--opponent random|rulebase] \\
      [--env-args JSON] [--skip-scored] [--device cuda|cpu]

--every N scores every N-th checkpoint in epoch order (and always the
last); --games G counts at least G finished matches a point (default
192); --envs E plays E matches at once (default 64); --env-args merges
env_args (``'{"torus_impl": "pallas"}'`` runs GeeseNet's trunk on the
port's kernel K1); --skip-scored skips epochs OUT.jsonl already holds for
the opponent. The device defaults to 'cuda'; without a card it raises
unless ``--device cpu`` is given.

Appends one JSON line per checkpoint, the JAX scorer's row: {"epoch": N,
"opponent": O, "games": G, "win_rate": W, "mean": M} with win_rate =
(mean outcome + 1) / 2. Prints each row, then one summary line
{"scored": ..., "seconds": ..., "kernel_launches": {path: {...}},
"rollout_graphs": ..., "dispatches": ...}: the launches were counted
from 0 at the first point, under the 'evaluation' path.
"""

import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def checkpoint_epochs(model_dir: str):
    """Sorted epochs of the ``<epoch>.ckpt`` files in model_dir."""
    return sorted(int(m.group(1)) for f in os.listdir(model_dir)
                  if (m := re.match(r'^(\d+)\.ckpt$', f)))


def pick_epochs(ckpts, every: int):
    """Every ``every``-th checkpoint, and always the last."""
    picks = [e for i, e in enumerate(ckpts) if i % every == 0]
    if ckpts and ckpts[-1] not in picks:
        picks.append(ckpts[-1])
    return picks


def scored_epochs(out_path: str, opponent: str):
    """Epochs OUT.jsonl already holds for ``opponent``."""
    scored = set()
    if not os.path.exists(out_path):
        return scored
    with open(out_path) as f:
        for line in f:
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if row.get('opponent') == opponent and 'epoch' in row:
                scored.add(row['epoch'])
    return scored


def score_row(epoch: int, opponent: str, results) -> dict:
    """The JAX scorer's row for a point's finished matches: the outcome
    of the evaluated seat, its mean and (mean + 1) / 2."""
    import numpy as np
    vals = [r['result'][r['args']['player'][0]] for r in results]
    mean = float(np.mean(vals))
    return {'epoch': epoch, 'opponent': opponent, 'games': len(vals),
            'win_rate': round((mean + 1) / 2, 4), 'mean': round(mean, 4)}


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog='scripts/torch_eval_checkpoints.py',
        description='score saved checkpoints with the device evaluator')
    ap.add_argument('model_dir')
    ap.add_argument('env')
    ap.add_argument('out')
    ap.add_argument('--every', type=int, default=5)
    ap.add_argument('--games', type=int, default=192)
    ap.add_argument('--envs', type=int, default=64)
    ap.add_argument('--opponent', default='random',
                    choices=('random', 'rulebase'))
    ap.add_argument('--env-args', default='{}')
    ap.add_argument('--skip-scored', action='store_true')
    ap.add_argument('--device', default='cuda')
    return ap.parse_args(argv)


def main(argv=None):
    a = parse_args(sys.argv[1:] if argv is None else argv)
    from handyrl_tpu_torch.device_generation import DeviceEvaluator
    from handyrl_tpu_torch.environment import make_device_env, make_env
    from handyrl_tpu_torch.model import (fp32_on_card, load_params_bytes,
                                         resolve_device)
    from handyrl_tpu_torch.ops import launches, reset_kernel_launches

    device = resolve_device(a.device)
    fp32_on_card(device)
    env_args = {'env': a.env, **json.loads(a.env_args)}
    env = make_env(env_args)
    env_mod = make_device_env(env_args)   # raises for an env without a twin

    ckpts = checkpoint_epochs(a.model_dir)
    picks = pick_epochs(ckpts, a.every)
    if a.skip_scored:
        scored = scored_epochs(a.out, a.opponent)
        picks = [e for e in picks if e not in scored]
        print('skip-scored: %d epochs already in %s' % (len(scored), a.out),
              flush=True)
    print('evaluating %d checkpoints of %d (every %d) from %s'
          % (len(picks), len(ckpts), a.every, a.model_dir), flush=True)

    net = env.net().to(device).eval()
    storage = [p.data_ptr() for p in net.parameters()]
    reset_kernel_launches()
    t0 = time.monotonic()
    ev = None
    rows = []
    with open(a.out, 'a') as out:
        for epoch in picks:
            with open(os.path.join(a.model_dir, '%d.ckpt' % epoch),
                      'rb') as f:
                # copies into the parameters the captured rollout reads
                load_params_bytes(net, f.read())
            if [p.data_ptr() for p in net.parameters()] != storage:
                raise RuntimeError('loading %d.ckpt moved the parameters: '
                                   'the captured rollout would score the old '
                                   'ones' % epoch)
            with launches.path('evaluation'):
                if ev is None:
                    ev = DeviceEvaluator(env_mod, net,
                                         {'eval': {'opponent': [a.opponent]}},
                                         n_envs=a.envs, chunk_steps=32,
                                         seed=1009, opponents=[a.opponent])
                else:
                    ev.flush()
                results = ev.play(a.games)
            row = score_row(epoch, a.opponent, results)
            out.write(json.dumps(row) + '\n')
            out.flush()
            rows.append(row)
            print(json.dumps(row), flush=True)
    graphs = int(ev is not None and getattr(ev._call, 'graph', None)
                 is not None)
    print(json.dumps({
        'scored': len(rows), 'seconds': time.monotonic() - t0,
        'kernel_launches': launches.by_path(), 'rollout_graphs': graphs,
        'dispatches': ev.dispatches if ev is not None else 0,
        'device': str(device)}), flush=True)
    return rows


if __name__ == '__main__':
    main()
