"""Side by side: the north-star curves of the PyTorch port and of the JAX
package, as the offline scorers wrote them, and the port's run rates.

Reads the scorer rows ({"epoch", "opponent", "games", "win_rate", "mean"})
of each curve and prints, for each: the win rate against 'random' at
epoch 10 and its mean over epochs 110-600; against 'rulebase' the points
of epochs 10-160 and the mean over epochs 360-600; the games a point.
With the port's metrics rows (``--metrics``, one row an epoch) it also
prints the run's epochs, episodes, wall seconds (first row to last),
episodes/s, SGD steps/s and seconds per 100 epochs. The last line is all
of it as one JSON object. The band the curves are held to is stated in
PERF.md and ROADMAP.md, not here.

Usage (from the root of the repository, every path optional):
  python scripts/torch_north_star_curves.py \\
      [--port north_star_torch_device_curve.jsonl \\
              north_star_torch_device_curve_rulebase.jsonl] \\
      [--metrics north_star_torch_device.jsonl]
"""

import argparse
import json
import os

PORT = ('north_star_torch_device_curve.jsonl',
        'north_star_torch_device_curve_rulebase.jsonl')
JAX = {'jax run 1': ('north_star_device_curve.jsonl',
                     'north_star_device_curve_rulebase.jsonl'),
       'jax run 5': ('north_star_device_curve_r5.jsonl',
                     'north_star_device_curve_rulebase_r5.jsonl')}
METRICS = 'north_star_torch_device.jsonl'


def rows(path):
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def mean_over(points, lo, hi):
    vals = [r['win_rate'] for r in points if lo <= r['epoch'] <= hi]
    return (sum(vals) / len(vals), len(vals)) if vals else (None, 0)


def curve_stats(random_path, rulebase_path):
    rnd, rule = rows(random_path), rows(rulebase_path)
    at = {r['epoch']: r['win_rate'] for r in rnd}
    rule_at = {r['epoch']: r['win_rate'] for r in rule}
    m_rnd, n_rnd = mean_over(rnd, 110, 600)
    m_rule, n_rule = mean_over(rule, 360, 600)
    return {
        'random_epoch10': at.get(10),
        'random_mean_110_600': m_rnd, 'random_points_110_600': n_rnd,
        'rulebase_10_160': {e: rule_at[e] for e in sorted(rule_at)
                            if e <= 160},
        'rulebase_mean_360_600': m_rule, 'rulebase_points_360_600': n_rule,
        'games_per_point': [min(r['games'] for r in rnd + rule),
                            max(r['games'] for r in rnd + rule)],
        'last_epoch': max(at),
    }


def run_stats(path):
    rs = [r for r in rows(path) if not r.get('preempted')]
    wall = rs[-1]['time'] - rs[0]['time']
    epochs = rs[-1]['epoch'] - rs[0]['epoch']
    episodes = rs[-1]['episodes'] - rs[0]['episodes']
    steps = rs[-1]['steps'] - rs[0]['steps']
    return {'epochs': rs[-1]['epoch'], 'episodes': rs[-1]['episodes'],
            'steps': rs[-1]['steps'], 'wall_s_first_to_last_row': wall,
            'episodes_per_s': episodes / wall, 'sgd_steps_per_s': steps / wall,
            's_per_100_epochs': 100 * wall / epochs}


def main(argv=None):
    ap = argparse.ArgumentParser(prog='scripts/torch_north_star_curves.py')
    ap.add_argument('--port', nargs=2, default=list(PORT))
    ap.add_argument('--metrics', default=METRICS)
    a = ap.parse_args(argv)
    out = {'port': curve_stats(*a.port)}
    for name, paths in JAX.items():
        if all(os.path.exists(p) for p in paths):
            out[name] = curve_stats(*paths)
    if a.metrics and os.path.exists(a.metrics):
        out['port_run'] = run_stats(a.metrics)
    for name, st in out.items():
        print('%s: %s' % (name, json.dumps(st)))
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
