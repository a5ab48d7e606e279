"""Seed sweep of the port's north-star quality run, on the card.

Runs ``scripts/torch_run_north_star.py --epochs 200 --seed S`` for seeds
0, 1 and 2, then scores epochs 10, 60, 110 and 160 of each run with
``scripts/torch_eval_checkpoints.py`` (1,000 games a point) against
'random' and 'rulebase', and prints one table row a seed. Each run is a
child process of its own; the scorer reads the run's ``<epoch>.ckpt``
files (``checkpoint_interval`` 10).

Usage:
  python scripts/torch_north_star_seeds.py [--out-dir DIR] [--device cuda]

Writes ``<out-dir>/metrics_s<S>.jsonl`` (the run's rows),
``<out-dir>/curve_s<S>.jsonl`` (the scorer's rows, both opponents) and
``<out-dir>/seeds.json`` (the table: each seed's win rates by opponent
and epoch with the games scored, and its run's JSON line); the model
dirs go to ``<out-dir>/models_s<S>``. Exits 1 when a run or a scoring failed.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEEDS = (0, 1, 2)
EPOCHS = 200
POINTS = (10, 60, 110, 160)     # the epochs scored, each a checkpoint
GAMES = 1000                    # games a point and opponent


def run(cmd):
    """Run ``cmd``, echoing its output; returns (exit code, seconds, the
    last JSON line it printed or None)."""
    print('+ ' + ' '.join(cmd), flush=True)
    t0 = time.monotonic()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{')]
    return (proc.returncode, time.monotonic() - t0,
            json.loads(lines[-1]) if lines else None)


def main(argv=None):
    ap = argparse.ArgumentParser(prog='scripts/torch_north_star_seeds.py')
    ap.add_argument('--out-dir', default='north_star_seeds')
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    os.makedirs(a.out_dir, exist_ok=True)
    py = sys.executable
    table, failed = [], False
    for seed in SEEDS:
        model_dir = os.path.join(a.out_dir, 'models_s%d' % seed)
        metrics = os.path.join(a.out_dir, 'metrics_s%d.jsonl' % seed)
        curve = os.path.join(a.out_dir, 'curve_s%d.jsonl' % seed)
        shutil.rmtree(model_dir, ignore_errors=True)
        for p in (metrics, curve):
            if os.path.exists(p):
                os.remove(p)
        rc, train_s, line = run([
            py, os.path.join(HERE, 'torch_run_north_star.py'),
            '--epochs', str(EPOCHS), '--seed', str(seed),
            '--model-dir', model_dir, '--metrics-out', metrics,
            '--device', a.device])
        if rc != 0:
            failed = True
            print('seed %d: the run exited %d' % (seed, rc), flush=True)
            continue
        # keep only POINTS, so the scorer's --every 1 takes
        # exactly them
        picked = os.path.join(a.out_dir, 'points_s%d' % seed)
        shutil.rmtree(picked, ignore_errors=True)
        os.makedirs(picked)
        for e in POINTS:
            src = os.path.join(model_dir, '%d.ckpt' % e)
            if not os.path.exists(src):
                failed = True
                print('seed %d: no %d.ckpt' % (seed, e), flush=True)
                continue
            shutil.copy(src, picked)
        rates = {}
        for opp in ('random', 'rulebase'):
            rc, _, _ = run([
                py, os.path.join(HERE, 'torch_eval_checkpoints.py'),
                picked, 'HungryGeese', curve, '--every', '1',
                '--games', str(GAMES), '--opponent', opp,
                '--env-args', '{"torus_impl": "pallas"}',
                '--device', a.device])
            failed |= rc != 0
        with open(curve) as f:
            for text in f:
                row = json.loads(text)
                rates.setdefault(row['opponent'], {})[row['epoch']] = \
                    (row['win_rate'], row['games'])
        entry = {'seed': seed, 'train_seconds': train_s,
                 'run': {k: (line or {}).get(k) for k in (
                     'epochs', 'episodes', 'wall_s', 'episodes_per_s',
                     'sgd_steps_per_s', 'device')},
                 'win_rate': rates}
        table.append(entry)
        print(json.dumps(entry), flush=True)
        shutil.rmtree(picked, ignore_errors=True)
    with open(os.path.join(a.out_dir, 'seeds.json'), 'w') as f:
        json.dump(table, f, indent=1)
    return 1 if failed else 0


if __name__ == '__main__':
    raise SystemExit(main())
