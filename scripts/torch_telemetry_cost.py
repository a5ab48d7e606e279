"""The host learner's rates with telemetry off and on (the default), on one
card in one call.

Runs ``python -m handyrl_tpu_torch.train`` on chip_smoke.py's phase 5
config (full-width GeeseNet, B=128, T=16, 64 generation envs, 2 epochs of
512 episodes after 256) twice over: with batcher threads (phase 5) and with
batcher processes building into shared memory (phase 5(b)). Each mode runs
off, on, on, off, so that a drift of the host over the call falls on both
arms alike. Neither arm traces episodes or profiles (no ``trace_dir``, no
``profile_epochs``): 'on' is the default block (registry, flight recorder,
alerts, the perf plane's memory sample and sentinel, the trainer's stage
timer).

    python scripts/torch_telemetry_cost.py [--blocks N]

Builds the kernels first. Prints one line a run, a table of each arm's
mean, and the card's name and power limit; writes the runs to
chiprun_out/telemetry_cost.json.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

KEYS = ('episodes_per_s', 'update_steps_per_s', 'trajectories_per_s',
        'trainer_batch_wait_seconds', 'train_seconds', 'wall')
MODES = {'threads': {}, 'shm processes': chip_smoke.BATCHER_SWITCHES}
ARMS = {'off': {'telemetry': {'enabled': False}}, 'on': {}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--blocks', type=int, default=1,
                    help='off-on-on-off blocks a mode (default 1)')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_telemetry_cost: no CUDA card', file=sys.stderr)
        sys.exit(1)
    from handyrl_tpu_torch.ops import cuda_build
    built = cuda_build.build()    # before the first run, which would time it
    print('kernels built: %s' % (built or 'all current'), flush=True)
    order = ['off', 'on', 'on', 'off'] * args.blocks
    runs = []
    for mode, switches in MODES.items():
        for arm in order:
            tmp = tempfile.mkdtemp(prefix='telemetry_cost_')
            try:
                line, wall = chip_smoke.run_learner_entry(
                    REPO, tmp, dict(switches, **ARMS[arm]),
                    device_flag=not switches)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            line['wall'] = wall
            row = {'mode': mode, 'telemetry': arm,
                   **{k: line.get(k) for k in KEYS}}
            runs.append(row)
            print('run %d: %s' % (len(runs), json.dumps(row)), flush=True)
    print('means, same card (%s):' % chip_smoke.nvidia_smi_line())
    print('  %-16s %-4s %s' % ('mode', 'arm', ' '.join(
        '%26s' % k for k in KEYS)))
    means = {}
    for mode in MODES:
        for arm in ARMS:
            sel = [r for r in runs if r['mode'] == mode
                   and r['telemetry'] == arm]
            m = {k: sum(r[k] for r in sel) / len(sel) for k in KEYS}
            means['%s/%s' % (mode, arm)] = m
            print('  %-16s %-4s %s' % (mode, arm, ' '.join(
                '%26.3f' % m[k] for k in KEYS)))
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'telemetry_cost.json'),
              'w') as f:
        json.dump({'card': chip_smoke.nvidia_smi_line(), 'runs': runs,
                   'means': means}, f, indent=1)


if __name__ == '__main__':
    main()
