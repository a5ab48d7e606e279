"""Config defaults and validation: the subset of ``handyrl_tpu/config.py``
the serving path and the local learner read, as plain dicts (the port
parses no YAML; the learner's CLI reads JSON with the ``env_args`` and
``train_args`` blocks of ``config.yaml``).

Differences from the JAX package: the inference engine runs on the device
given to the service (``--device``, default 'cuda'), so
``inference.engine_backend`` does not exist here, and the fleet, gateway,
metrics-exporter and alert knobs wait for their modules. The learner's
``TRAIN_DEFAULTS`` hold the knobs of the local learner and of the fused
device loop, and
:func:`validate` raises for anything this port does not run yet (device
generation without the fused loop, the threaded replay trainer, turn-based
device training, batcher processes, streaming, the league, mesh
parallelism, the worker plane, recurrent nets, BatchNorm, envs other than
Hungry Geese) instead of ignoring it.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

INFERENCE_DEFAULTS: Dict[str, Any] = {
    'batch_wait_ms': 2.0,   # coalescing deadline: how long the engine holds the oldest request while the batch fills
    'max_batch': 64,        # request cap per dispatched forward batch
    'vault_size': 3,        # materialized model snapshots cached engine-side
    'queue_max': 1024,      # bounded intake queue: submits past it are shed with an immediate error reply; 0 = unbounded
}

SERVING_DEFAULTS: Dict[str, Any] = {
    'port': 9997,           # listen port; 0 = ephemeral (reported on the ready line)
    'host': '',             # bind host ('' = all interfaces)
    'line': 'default',      # model line for bare-integer request ids ('<line>@<mid>')
    'registry_dir': 'models',  # ModelRegistry root
    'engines': 1,           # InferenceEngines in the process; models partition across them by handle
    'max_clients': 64,      # admission control: connections past this are refused with an error frame
    'drain_timeout': 30.0,  # graceful-drain deadline (s) on SIGTERM before exit 75
    'lock_timeout': 10.0,   # registry manifest-lock deadline (s)
}


def serving_args(env: Dict[str, Any], inference: Dict[str, Any] = None,
                 serving: Dict[str, Any] = None) -> Dict[str, Any]:
    """The args dict an InferenceService takes: ``{'env', 'inference',
    'serving'}`` with the defaults filled in under the given overrides."""
    inf = copy.deepcopy(INFERENCE_DEFAULTS)
    inf.update(inference or {})
    srv = copy.deepcopy(SERVING_DEFAULTS)
    srv.update(serving or {})
    return {'env': dict(env), 'inference': inf, 'serving': srv}


TRAIN_DEFAULTS: Dict[str, Any] = {
    'turn_based_training': True,
    'observation': False,
    'gamma': 0.8,
    'forward_steps': 16,
    'burn_in_steps': 0,           # > 0 needs the recurrent loss path (not ported)
    'compress_steps': 4,
    'compress_level': 9,          # bz2 compresslevel for episode moments (1 fastest .. 9 smallest)
    'entropy_regularization': 1.0e-1,
    'entropy_regularization_decay': 0.1,
    'update_episodes': 200,
    'batch_size': 128,
    'minimum_episodes': 400,
    'maximum_episodes': 100000,
    'epochs': -1,
    'num_batchers': 2,            # batcher threads
    'eval_rate': 0.1,
    'lambda': 0.7,
    'policy_target': 'TD',        # 'UPGO' 'VTRACE' 'TD' 'MC'
    'value_target': 'TD',         # 'VTRACE' 'TD' 'MC' 'UPGO'
    'eval': {'opponent': ['random']},  # 'random', 'rulebase[-key]' or .ckpt paths
    'seed': 0,
    'restart_epoch': 0,           # resume from model_dir/<n>.ckpt and trainer_state.ckpt; -1 = the newest checkpoint that passes verification (0 when none)
    'batched_generation': True,   # in-process vectorized self-play (the only generation the port runs)
    'generation_envs': 64,        # env count of the batched generator
    'eval_envs': None,            # concurrent online-eval matches; None = max(4, generation_envs // 8)
    'model_dir': 'models',        # checkpoint directory
    # the fused device loop (device_generation.py, ops/fused_pipeline.py):
    # both switches on, with fused_pipeline and device_ingest at True
    'device_generation': False,   # rollouts on the device (envs with a tensor twin)
    'device_replay': False,       # the replay ring on the device; batches sampled there
    'device_chunk_steps': 16,     # plies of a rollout chunk (one dispatch)
    'device_eval': True,          # evaluation matches on the device when every opponent is 'random' or 'rulebase'
    'device_ingest': True,        # training windows assembled on the device
    'replay_windows_per_episode': None,  # windows an episode contributes (and the ring's budget per episode); None = max(1, 64 // forward_steps)
    'fused_pipeline': True,       # one dispatch = rollout chunk + ingest + K SGD steps
    'sgd_steps_per_chunk': None,  # SGD steps a fused dispatch (pins the replay ratio); None = 16
    'checkpoint_interval': 1,     # fused loop: write checkpoint files every N epochs (and at the last)
    'guard': {
        'nonfinite_policy': 'rollback',  # 'skip', 'rollback' (after rollback_after consecutive bad updates or a loss-spike trip) or 'abort'
        'rollback_after': 8,
        'loss_spike_zscore': 0.0,  # > 0: also roll back on a finite loss this many EMA stddevs from its mean
        'check_episodes': True,    # drop episodes with non-finite data before they reach the buffer
    },
    'decode_cache_blocks': 1024,  # LRU capacity (bz2 blocks) of the batchers' decoded-moment cache; 0 disables
    'prefetch_depth': 2,          # batches staged to the device (pinned host memory, a copy stream) ahead of the step
}

WORKER_DEFAULTS: Dict[str, Any] = {
    'server_address': '',
    'num_parallel': 8,
    'backend': '',
}

# train_args knobs of the JAX package that select what the port does not run
# yet, with the one value of each that it does run (their JAX defaults)
NOT_PORTED: Dict[str, Any] = {
    'batcher_processes': False,
    'batcher_shared_memory': False,
}
# blocks of planes the port does not have yet: each turns its plane on
# when one of the named keys is set (truthy; model_parallel above 1)
NOT_PORTED_BLOCKS: Dict[str, tuple] = {
    'streaming': ('enabled', 'staleness_half_life', 'target_clip'),
    'league': ('enabled',),
    'parallel': ('model_parallel', 'partition_rules'),
    'distributed': ('coordinator_address', 'num_processes', 'process_id'),
}

_ENV_KEYS = ('env', 'torus_impl', 'norm_kind', 'net_kind')
_TARGETS = ('MC', 'TD', 'VTRACE', 'UPGO')


class ConfigError(ValueError):
    """A config the port cannot run; the message names the key."""


def _merge(defaults: Dict[str, Any], overrides: Dict[str, Any]
           ) -> Dict[str, Any]:
    out = copy.deepcopy(defaults)
    for k, v in (overrides or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def apply_defaults(raw: Dict[str, Any]) -> Dict[str, Any]:
    """``{'env_args', 'train_args', 'worker_args'}`` with the defaults
    filled in under ``raw``'s blocks; raises :class:`ConfigError` (after
    :func:`validate`) for anything the port does not run."""
    unknown = sorted(set(raw) - {'env_args', 'train_args', 'worker_args'})
    if unknown:
        raise ConfigError('unknown config blocks %s' % unknown)
    args = {
        'env_args': dict(raw.get('env_args', {'env': 'HungryGeese'})),
        'train_args': _merge(TRAIN_DEFAULTS, raw.get('train_args', {})),
        'worker_args': _merge(WORKER_DEFAULTS, raw.get('worker_args', {})),
    }
    validate(args)
    return args


def _require(cond: bool, msg: str):
    if not cond:
        raise ConfigError(msg)


def validate(args: Dict[str, Any]) -> None:
    """Raise :class:`ConfigError` for a config the local learner cannot run
    as given: a value out of range, or a knob of a part of the JAX package
    the port does not have yet (named in the message)."""
    ta, env = args['train_args'], args['env_args']
    pending = 'is not ported yet (ROADMAP.md)'

    _require(args.get('worker_args', WORKER_DEFAULTS) == WORKER_DEFAULTS,
             'worker_args: the worker plane %s' % pending)
    _require(env.get('env') == 'HungryGeese',
             'env_args.env %r: only HungryGeese %s' % (env.get('env'),
                                                      'is ported'))
    extra = sorted(set(env) - set(_ENV_KEYS))
    _require(not extra, 'env_args keys %s are not known to the port' % extra)
    _require(env.get('norm_kind', 'group') == 'group',
             "env_args.norm_kind %r: norm_kind='batch' training %s"
             % (env.get('norm_kind'), pending))
    _require(env.get('net_kind', 'conv') == 'conv',
             'env_args.net_kind %r: recurrent nets %s'
             % (env.get('net_kind'), pending))
    _require(env.get('torus_impl', 'pad') in ('pad', 'halo', 'pallas'),
             'env_args.torus_impl %r is unknown' % (env.get('torus_impl'),))

    extra = sorted(set(ta) - set(TRAIN_DEFAULTS) - set(NOT_PORTED)
                   - set(NOT_PORTED_BLOCKS) - {'env'})
    _require(not extra, 'train_args keys %s: the port\'s learner does not '
             'run them; the parts they configure %s' % (extra, pending))
    for key, value in NOT_PORTED.items():
        _require(ta.get(key, value) == value,
                 'train_args.%s %r: %s' % (key, ta.get(key), pending))
    for key, switches in NOT_PORTED_BLOCKS.items():
        block = ta.get(key) or {}
        on = [k for k in switches if block.get(k)
              and not (k == 'model_parallel' and int(block[k]) == 1)]
        _require(not on, 'train_args.%s.%s: the %s plane %s'
                 % (key, on[0] if on else '', key, pending))
    _require(ta['batched_generation'] is True,
             'train_args.batched_generation False: the worker-cluster '
             'generation %s' % pending)
    _validate_device_path(ta, pending)
    _require(ta['burn_in_steps'] == 0,
             'train_args.burn_in_steps %r: burn-in (the recurrent loss '
             'path) %s' % (ta['burn_in_steps'], pending))
    _require(ta['policy_target'] in _TARGETS,
             'policy_target %r not in %s' % (ta['policy_target'], _TARGETS))
    _require(ta['value_target'] in _TARGETS,
             'value_target %r not in %s' % (ta['value_target'], _TARGETS))
    for key in ('forward_steps', 'compress_steps', 'batch_size',
                'update_episodes', 'num_batchers', 'generation_envs',
                'prefetch_depth'):
        _require(int(ta[key]) >= 1, '%s must be >= 1' % key)
    _require(int(ta['minimum_episodes']) >= 0, 'minimum_episodes must be >= 0')
    _require(0.0 <= float(ta['eval_rate']) <= 1.0,
             'eval_rate must be a fraction in [0, 1]')
    _require(int(ta['restart_epoch']) >= -1, 'restart_epoch must be >= -1')
    _require(1 <= int(ta['compress_level']) <= 9,
             'compress_level must be a bz2 compresslevel in 1..9')
    g = ta['guard']
    extra = sorted(set(g) - set(TRAIN_DEFAULTS['guard']))
    _require(not extra, 'guard keys %s: what they configure %s'
             % (extra, pending))
    _require(str(g['nonfinite_policy']) in ('skip', 'rollback', 'abort'),
             "guard.nonfinite_policy must be 'skip', 'rollback' or 'abort'")
    _require(int(g['rollback_after']) >= 1, 'guard.rollback_after must be '
             '>= 1')
    _require(float(g['loss_spike_zscore']) >= 0,
             'guard.loss_spike_zscore must be >= 0 (0 disables the trip)')


def _validate_device_path(ta: Dict[str, Any], pending: str) -> None:
    """The device path runs as the fused loop in solo layout only: both
    switches, ``fused_pipeline`` and ``device_ingest`` on, simultaneous
    training (HungryGeese is checked for every config)."""
    gen, replay = bool(ta['device_generation']), bool(ta['device_replay'])
    _require(gen or not replay,
             'train_args.device_replay without device_generation: the '
             'threaded replay trainer (DeviceReplay.push/sample) %s' % pending)
    _require(replay or not gen,
             'train_args.device_generation without device_replay: the split '
             'device pipeline (DeviceGenerator) %s' % pending)
    if not gen:
        return
    _require(bool(ta['fused_pipeline']),
             'train_args.fused_pipeline false: the threaded replay trainer '
             '%s' % pending)
    _require(bool(ta['device_ingest']),
             'train_args.device_ingest false: host-built windows pushed to '
             'the device ring (DeviceReplay.push) %s' % pending)
    _require(not ta['turn_based_training'],
             "train_args.turn_based_training true on the device path: the "
             "'turn' ingest layout and the turn-based device envs %s"
             % pending)
    for key in ('device_chunk_steps', 'checkpoint_interval'):
        _require(int(ta[key]) >= 1, '%s must be >= 1' % key)
    for key in ('sgd_steps_per_chunk', 'replay_windows_per_episode',
                'eval_envs'):
        _require(ta[key] is None or int(ta[key]) >= 1,
                 '%s must be None or >= 1' % key)
