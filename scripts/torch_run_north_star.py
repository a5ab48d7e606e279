"""North-star quality run of the PyTorch port: long Hungry Geese self-play
on the fused device loop, on the card.

The counterpart of ``scripts/run_north_star.py``: the same configuration
(``BASE``: B=64, T=16, VTRACE/VTRACE, 64 generation envs, 32-ply chunks,
32 eval envs, 64 SGD steps a chunk, 200 episodes before the first epoch
and 100 an epoch, checkpoint files every 10 epochs), driven through
``handyrl_tpu_torch.train.Learner``, with GeeseNet's trunk on the port's
kernels (``torus_impl='pallas'``). One metrics_jsonl row per epoch; the
offline curve comes from ``scripts/torch_eval_checkpoints.py`` on the
checkpoints.

Auto-resume: when the model dir already holds a checkpoint that passes
its CRC check, training restarts from the newest one (params, optimizer
state, steps), so one curve spans interrupted windows. The replay ring is
not saved: a resumed run plays ``minimum_episodes`` again before it
trains, as the JAX package's does.

Usage:
  python scripts/torch_run_north_star.py [--epochs N] [--host] \\
      [--budget-s S] [--metrics-out PATH] [--model-dir DIR] \\
      [--device cuda|cpu]

--budget-s sets HANDYRL_TPU_DEADLINE (unless it is set already): the run
stops at the first safe point past it and writes its final checkpoint;
without --epochs a budgeted run is bounded by the budget alone (default
600 epochs otherwise). --host runs the same net, targets and cadence on
the host learner (batched generation of 16 envs, the thread batchers and
the graphed step) instead of the fused loop: the control that splits the
device loop from the shared loss and step code. --metrics-out redirects
the rows (default north_star_torch_<tag>.jsonl); --model-dir defaults to
models_north_star_torch_<tag>. Exits 75 after a SIGTERM (checkpoint
flushed: run it again to resume).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

BASE = {
    'env_args': {'env': 'HungryGeese', 'torus_impl': 'pallas'},
    'train_args': {'batch_size': 64, 'forward_steps': 16,
                   'update_episodes': 100, 'minimum_episodes': 200,
                   'generation_envs': 64,
                   'turn_based_training': False, 'observation': True,
                   'gamma': 0.99,
                   'policy_target': 'VTRACE', 'value_target': 'VTRACE',
                   'device_generation': True, 'device_replay': True,
                   'device_chunk_steps': 32, 'eval_envs': 32,
                   'sgd_steps_per_chunk': 64,
                   'checkpoint_interval': 10},
}
DEVICE_ONLY = ('device_generation', 'device_replay', 'device_chunk_steps',
               'eval_envs', 'sgd_steps_per_chunk')


def config(host: bool, epochs: int, model_dir: str, metrics: str,
           start: int) -> dict:
    """The run's raw config: BASE, or its host-learner control."""
    raw = json.loads(json.dumps(BASE))
    ta = raw['train_args']
    if host:
        for k in DEVICE_ONLY:
            ta.pop(k)
        ta['generation_envs'] = 16
    ta.update(model_dir=model_dir, metrics_jsonl=metrics, epochs=epochs,
              restart_epoch=start)
    return raw


def main(argv=None):
    ap = argparse.ArgumentParser(prog='scripts/torch_run_north_star.py')
    ap.add_argument('--epochs', type=int, default=None)
    ap.add_argument('--host', action='store_true')
    ap.add_argument('--budget-s', type=float, default=None)
    ap.add_argument('--metrics-out', default=None)
    ap.add_argument('--model-dir', default=None)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from handyrl_tpu_torch import guard
    from handyrl_tpu_torch.config import apply_defaults
    from handyrl_tpu_torch.model import fp32_on_card, resolve_device
    from handyrl_tpu_torch.ops import reset_kernel_launches
    from handyrl_tpu_torch.train import Learner

    tag = 'host' if a.host else 'device'
    model_dir = a.model_dir or 'models_north_star_torch_%s' % tag
    metrics = a.metrics_out or 'north_star_torch_%s.jsonl' % tag
    epochs = a.epochs
    if epochs is None:
        # a budgeted run is bounded by its budget unless an epoch cap is given
        epochs = 10 ** 6 if a.budget_s is not None else 600
    start, _ = guard.newest_valid_epoch(model_dir)
    if a.budget_s is not None:
        os.environ.setdefault('HANDYRL_TPU_DEADLINE',
                              str(time.time() + a.budget_s))
    args = apply_defaults(config(a.host, epochs, model_dir, metrics, start))

    device = resolve_device(a.device)
    fp32_on_card(device)
    reset_kernel_launches()
    print('north-star %s run: epochs %d->%d, model_dir=%s' %
          (tag, start, epochs, model_dir), flush=True)
    t0 = time.time()
    learner = Learner(args, device=device)
    learner.run()
    line = learner.summary()
    print(json.dumps({
        'row': 'north-star-torch-%s' % tag,
        'epochs': learner.model_epoch,
        'episodes': learner.num_returned_episodes,
        'wall_s': round(time.time() - t0, 1),
        'episodes_per_s': line['episodes_per_s'],
        'sgd_steps_per_s': line.get('sgd_steps_per_s',
                                    line['update_steps_per_s']),
        'kernel_launches': line['kernel_launches'],
        'device': line['device']}), flush=True)
    if learner.preempt.fired:
        return guard.PREEMPT_EXIT_CODE
    return 1 if learner.trainer.failed else 0


if __name__ == '__main__':
    raise SystemExit(main())
