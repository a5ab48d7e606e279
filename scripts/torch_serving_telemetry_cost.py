"""The serving tier's ply latency with tracing off and on, process by
process, on one card in one call.

Runs chip_smoke.py's phase 19 alone (``--serve-fleet`` with 2 replicas of
the full-width GeeseNet on the card, ``--gateway`` over it under the
runtime sanitizer, and a second gateway without it) with its telemetry A/B
widened: on the warm fleet after 19(b), rounds of 8 clients x 2 matches
(no kill) on the plain gateway with tracing on in none, the gateway, the
replicas or both (the ``trace`` op switches each process), and on the
sanitized gateway traced, in ORDER, --blocks times over. ORDER reads the
same forwards and backwards, so that a drift of the host over the call
falls on every arm alike. Every other check of phase 19 runs as in the
script.

    python scripts/torch_serving_telemetry_cost.py [--blocks N]

Builds the kernels first. Prints each arm's rounds' ply p50 (ms), its
pooled p50 and matches/s, and the card's name and power limit; writes the
arms to chiprun_out/serving_telemetry_cost.json.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

# (the gateway a round plays on, that gateway traced, the replicas traced)
ORDER = (('plain', False, False), ('plain', True, False),
         ('plain', False, True), ('plain', True, True),
         ('sanitized', True, True), ('sanitized', True, True),
         ('plain', True, True), ('plain', False, True),
         ('plain', True, False), ('plain', False, False))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--blocks', type=int, default=2,
                    help='passes over ORDER (default 2)')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_serving_telemetry_cost: no CUDA card', file=sys.stderr)
        sys.exit(1)
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.models.geese import GeeseNet
    from handyrl_tpu_torch.ops import cuda_build
    built = cuda_build.build()
    print('kernels built: %s' % (built or 'all current'), flush=True)
    prep = chip_smoke.phase_fleet_prepare(torch, make_env, GeeseNet)
    out = chip_smoke.phase_fleet_run(REPO, prep,
                                     ab_order=ORDER * args.blocks)
    arms = out['ab']
    print('%-26s %6s %9s %11s  %s' % ('arm', 'rounds', 'p50 ms',
                                      'matches/s', 'rounds\' p50 ms'))
    for name in sorted(arms):
        arm = arms[name]
        print('%-26s %6d %9.2f %11.3f  %s' % (
            name, arm['rounds'], arm['ply_p50_ms'], arm['matches_per_s'],
            ' '.join('%.1f' % v for v in arm['round_p50_ms'])))
    card = chip_smoke.nvidia_smi_line()
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out',
                           'serving_telemetry_cost.json'), 'w') as f:
        json.dump({'card': card, 'blocks': args.blocks, 'arms': arms,
                   'ab_seconds': out['ab_seconds'],
                   'phase_seconds': out['seconds']}, f, indent=1)
    print(card)


if __name__ == '__main__':
    main()
