"""Config defaults and validation: the subset of ``handyrl_tpu/config.py``
the serving path and the local learner read, as plain dicts (the port
parses no YAML; the learner's CLI reads JSON with the ``env_args`` and
``train_args`` blocks of ``config.yaml``).

Differences from the JAX package: an inference engine runs on the device
of its process (the service's ``--device``, a gather's ``worker.device``,
default 'cuda'), so ``inference.engine_backend`` keeps its check ('cpu'
or 'device') but does not move the engine: the JAX default 'cpu' never
puts the port's engine on the host (ROADMAP.md §3). The serving fleet's
and the match gateway's blocks (``serving.fleet``, ``serving.gateway``)
have the JAX defaults and checks, and each tier's ``metrics_port``
(``serving.metrics_port``, ``serving.fleet.metrics_port``,
``serving.gateway.metrics_port``) starts that tier's Prometheus exporter
and ``/statusz``, as in the JAX package. The learner's
``TRAIN_DEFAULTS`` hold the knobs of the local learner, of the fused
device loop, of the worker plane (``batched_generation: false``,
``worker``, ``fault_tolerance``, the gathers' ``generation`` backend, the
per-host inference engine's ``inference`` block and the workers'
``serving.endpoint``; ``WORKER_DEFAULTS`` for a worker host)
and of the run plane (``metrics_jsonl``, ``keep_checkpoints``,
``init_params``, ``guard.preempt_signals``, the publish hook's ``serving``
block) and of telemetry (the ``telemetry`` block or bool,
``telemetry_port``, ``profile_epochs``, ``profile_dir``, with the JAX
defaults and checks) and of the durable plane (``durability``, ``streaming`` with the
IMPACT target network) and of the league (``league``: PFSP opponents
over the registry, the rating book, rating-gated promotion), and
:func:`validate` raises for anything this port does not run yet (mesh
parallelism, nets other than the ported ones)
instead of ignoring it.
Without ``env_args`` the env is TicTacToe, as in the JAX package.
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

# the serving fleet (serving/fleet.py): a ServiceResolver fronting N
# InferenceService replicas that register and heartbeat their SLO
# snapshots; clients route through it with a breaker a replica
FLEET_DEFAULTS: Dict[str, Any] = {
    'resolver': '',              # 'host:port' of the ServiceResolver a replica registers and heartbeats with; '' = a standalone service
    'port': 0,                   # resolver listen port (--serve-fleet); 0 = ephemeral (reported on the fleet_ready line)
    'replica': '',               # this replica's stable name; '' = assigned by the resolver. A respawned replica re-registering under its old name is re-admitted at once
    'advertise': '',             # endpoint host advertised to the resolver ('' = the bind host, or 127.0.0.1 when binding all interfaces)
    'heartbeat_interval': 2.0,   # replica -> resolver liveness and SLO beacon period (s)
    'heartbeat_timeout': 10.0,   # the resolver drains a replica silent this long (s); must exceed heartbeat_interval
    'refresh_interval': 2.0,     # router-side replica-table refresh period (s); failures also force a refresh
    'replicas': 2,               # replicas the resolver spawns and supervises under --serve-fleet (0 = external replicas only)
    'min_replicas': 1,           # autoscaler floor: an idle drain never shrinks the routable fleet below it
    'max_replicas': 4,           # autoscaler ceiling: an SLO-breach admission never grows past it
    'autoscale': False,          # admit a standby replica on a sustained p99/shed breach, drain one on sustained idleness (SIGTERM, exit 75)
    'slo_p99_ms': 0.0,           # autoscaler p99 latency breach threshold (ms); 0 = breach only on request sheds
    'breach_window': 10.0,       # an SLO breach must last this long (s) before a replica is admitted
    'idle_window': 60.0,         # the fleet must be idle this long (s) before a replica is drained
    'quarantine_period': 30.0,   # quarantine (s) before a silent replica is re-admitted (a re-registration re-admits it at once)
    'metrics_port': 0,           # resolver-side Prometheus /metrics + /statusz port (0 = exporter off); the fleet's alert engine and replica-state view live here
}

# the match gateway (serving/gateway.py): game sessions over the fleet
GATEWAY_DEFAULTS: Dict[str, Any] = {
    'port': 0,               # gateway listen port (--gateway); 0 = ephemeral (reported on the gateway_ready line)
    'resolver': '',          # 'host:port' of the fleet resolver the gateway routes plies through; '' = serving.fleet.resolver
    'model': 'default@champion',  # opponent spec of a session whose client names none; a floating selector is pinned to line@version at open
    'workers': 4,            # session worker threads, each with its own RoutedClient
    'max_sessions': 64,      # admission control: opens past it are shed with an error reply (plies never are)
    'ply_timeout': 15.0,     # per-ply fleet round-trip deadline (s); also bounds journal replays
    'monitor_interval': 0.5, # fleet-table poll period (s) of the handoff/reconstruct monitor (and the workers' routers)
    'session_timeout': 600.0,  # a session with no ply this long (s) is reaped as a drop
    'metrics_port': 0,       # gateway-side Prometheus /metrics + /statusz port (0 = exporter off)
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
    'metrics_port': 0,      # service-side Prometheus /metrics + /statusz port (0 = exporter off)
    'fleet': FLEET_DEFAULTS,
    'gateway': GATEWAY_DEFAULTS,
}


def serving_args(env: Dict[str, Any], inference: Dict[str, Any] = None,
                 serving: Dict[str, Any] = None,
                 telemetry: Any = None) -> Dict[str, Any]:
    """The args dict an InferenceService (and the fleet's resolver and the
    match gateway) takes: ``{'env', 'inference', 'serving'}`` with the
    defaults filled in under the given overrides, and the ``telemetry``
    block (or bool) when one is given; raises :class:`ConfigError` for a
    block the port cannot run."""
    inf = copy.deepcopy(INFERENCE_DEFAULTS)
    inf.update(inference or {})
    srv = _merge(SERVING_DEFAULTS, serving or {})
    validate_serving(srv)
    out = {'env': dict(env), 'inference': inf, 'serving': srv}
    if telemetry is not None:
        _validate_telemetry_block(telemetry)
        out['telemetry'] = copy.deepcopy(telemetry)
    return out


TRAIN_DEFAULTS: Dict[str, Any] = {
    'turn_based_training': True,
    'observation': False,
    'gamma': 0.8,
    'forward_steps': 16,
    'burn_in_steps': 0,           # leading steps of each window that only warm the recurrent state (no loss); nets without a state ignore it
    'compress_steps': 4,
    'compress_level': 9,          # bz2 compresslevel for episode moments (1 fastest .. 9 smallest)
    'entropy_regularization': 1.0e-1,
    'entropy_regularization_decay': 0.1,
    'update_episodes': 200,
    'batch_size': 128,
    'minimum_episodes': 400,
    'maximum_episodes': 100000,
    'epochs': -1,
    'num_batchers': 2,            # batcher threads (or processes)
    'batcher_processes': False,   # build batches in spawned CPU processes instead of threads
    'batcher_shared_memory': False,  # with batcher_processes: children build batches in shared-memory slots the trainer maps (no pickle over the pipe); a slot is freed once the batch was copied into the staging buffers
    'eval_rate': 0.1,
    'lambda': 0.7,
    'policy_target': 'TD',        # 'UPGO' 'VTRACE' 'TD' 'MC'
    'value_target': 'TD',         # 'VTRACE' 'TD' 'MC' 'UPGO'
    'eval': {'opponent': ['random']},  # 'random', 'rulebase[-key]' or .ckpt paths
    'seed': 0,
    'restart_epoch': 0,           # resume from model_dir/<n>.ckpt and trainer_state.ckpt; -1 = the newest checkpoint that passes verification (0 when none)
    'init_params': '',            # warm start: load model params (a .ckpt of the same architecture, written by either package) at epoch 0, fresh optimizer and counters
    'batched_generation': True,   # in-process vectorized self-play; False = a local worker cluster (gather and worker processes)
    'generation_envs': 64,        # env count of the batched generator
    'worker': {'num_parallel': 6},  # the local worker cluster's worker processes (batched_generation false)
    # the worker plane's fault tolerance (worker.py, train.py server()):
    # heartbeats, silent-peer detach, supervised reconnect, task re-issue
    # and the per-host health states (fault.FleetController)
    'fault_tolerance': {
        'heartbeat_interval': 10.0,    # beacon period (s) of workers and socket gathers
        'liveness_timeout': 60.0,      # detach a silent socket peer after (s); must exceed heartbeat_interval
        'rpc_timeout': 120.0,          # a gather's blocking RPC deadline (s)
        'task_deadline': 300.0,        # re-issue a task not returned within (s)
        'reconnect_initial_delay': 1.0,  # first reconnect backoff step (s); doubles per failure, jittered
        'reconnect_max_delay': 30.0,   # backoff ceiling (s)
        'reconnect_max_tries': 30,     # redials before a gather gives up (and respawns before a worker host gives up a gather slot)
        'resend_buffer': 256,          # unacknowledged uploads a gather keeps across reconnects; older ones are dropped and counted
        'host_degrade_after': 1,       # fault signals within host_health_window before a host is degraded
        'host_quarantine_after': 3,    # strandings within the window before a host is drained, then quarantined
        'host_health_window': 120.0,   # sliding window (s) of a host's fault accounting
        'host_quarantine_period': 60.0,  # quarantine (s) before a flapping host is re-admitted
    },
    'eval_envs': None,            # concurrent online-eval matches; None = max(4, generation_envs // 8)
    'model_dir': 'models',        # checkpoint directory
    'metrics_jsonl': '',          # optional path: one JSON row per closed epoch (and a 'preempted' row)
    'keep_checkpoints': 0,        # GC numbered <epoch>.ckpt beyond the newest N after each save (0 = keep all; registry-pinned versions and checkpoint eval opponents are never deleted)
    # the device paths (device_generation.py, ops/replay.py,
    # ops/fused_pipeline.py): both switches with fused_pipeline and
    # device_ingest at True run the fused loop; the other combinations the
    # split generator and the threaded replay trainer
    'device_generation': False,   # rollouts on the device (envs with a tensor twin)
    'device_replay': False,       # the replay ring on the device; batches sampled there
    'device_chunk_steps': 16,     # plies of a rollout chunk (one dispatch)
    'device_eval': True,          # evaluation matches on the device when every opponent is 'random' or 'rulebase'
    'device_ingest': True,        # training windows assembled on the device
    'replay_windows_per_episode': None,  # windows an episode contributes (and the ring's budget per episode); None = max(1, 64 // forward_steps)
    'replay_fused_steps': 8,      # SGD steps a dispatch of the threaded replay trainer
    'max_sample_reuse': None,     # threaded replay trainer: cap samples drawn / windows ingested (None = free-spin)
    'fused_pipeline': True,       # one dispatch = rollout chunk + ingest + K SGD steps
    'sgd_steps_per_chunk': None,  # SGD steps a fused dispatch (pins the replay ratio); None = 16
    'checkpoint_interval': 1,     # fused loop: write checkpoint files every N epochs (and at the last)
    'guard': {
        'nonfinite_policy': 'rollback',  # 'skip', 'rollback' (after rollback_after consecutive bad updates or a loss-spike trip) or 'abort'
        'rollback_after': 8,
        'loss_spike_zscore': 0.0,  # > 0: also roll back on a finite loss this many EMA stddevs from its mean
        'check_episodes': True,    # drop episodes with non-finite data before they reach the buffer
        'preempt_signals': True,   # SIGTERM/SIGINT: flush a full checkpoint at the next safe point and exit 75 (restart into restart_epoch -1)
    },
    # the per-host inference engine of a gather (inference.py:
    # EngineSupervisor, EngineClient): workers hold no params and send
    # their plies to one engine a host, which coalesces them into batched
    # forwards on the gather's device (the worker plane only)
    'inference': {
        'enabled': False,         # route the workers' inference through their gather's engine
        'batch_wait_ms': 2.0,     # coalescing deadline: how long the engine holds the oldest request while the batch fills (it dispatches early once every local worker has a request in flight)
        'max_batch': 64,          # request cap per dispatched forward batch
        'engine_backend': 'cpu',  # checked ('cpu' or 'device') as in the JAX package; the port's engine runs on worker.device (default 'cuda') for both
        'vault_size': 3,          # materialized model snapshots cached (engine-side, and in a degraded worker's local vault)
        'queue_max': 1024,        # bounded engine intake queue: submits past it are shed with an immediate error reply; 0 = unbounded
        'stall_timeout': 30.0,    # watchdog: a busy engine with no tick progress for this long is declared stalled, its requests error-answered, and a fresh engine started
        'restart_max_delay': 10.0,  # engine-restart backoff ceiling (s); the first restart after 0.5 s, doubling
        'request_timeout': 10.0,  # a worker's deadline (s) on one engine round trip
        'request_retries': 1,     # resends after a timeout before the worker gives up on the engine for that request
        'failover': True,         # degrade to per-worker inference when the engine is unreachable (lossless: records stay byte-identical); False = raise, losing that episode
        'reprobe_initial_delay': 2.0,  # circuit breaker: first half-open probe (s) after a degradation, doubling up to reprobe_max_delay
        'reprobe_max_delay': 30.0,     # probe backoff ceiling (s)
    },
    # the learner's publish hook (the serving tier's registry) and the
    # workers' remote service
    'serving': {
        'endpoint': '',           # 'host:port' of an InferenceService (or a comma-separated list of replicas) that engine-mode workers dial instead of their gather's engine; a dead replica rotates to the next, and only with every one down does a worker degrade to its own forward
        'line': 'default',        # model line the publish hook registers versions on
        'registry_dir': '',       # ModelRegistry root; '' = model_dir
        'publish': False,         # register every numbered checkpoint as '<line>@<epoch>' (pinning it against keep_checkpoints GC)
        'auto_promote': True,     # with publish: each published version also becomes the line's champion
        'metrics_port': 0,        # the service's Prometheus /metrics + /statusz port (0 = exporter off)
        'fleet': FLEET_DEFAULTS,  # with 'resolver': engine-mode workers route through the fleet's replica table (EngineClient._refresh_endpoints)
        'gateway': GATEWAY_DEFAULTS,
    },
    # the gathers' actor engine (worker.py gather_loop, DeviceActorGather;
    # device_generation.DeviceActorEngine), read on the worker plane only
    'generation': {
        'backend': '',            # '' = auto ('engine' with inference.enabled, else 'worker'); 'worker' = per-worker stepping, 'engine' = the per-host inference engine on the gather's card, 'device' = the fused rollout on the gather's card (envs with a tensor twin); a worker host overrides it with worker_args.backend
        'device_actor_envs': 64,  # lanes of the device actor's chunk: one ledger task a lane
        'device_actor_chunk_steps': 16,  # plies of a chunk (one CUDA graph replay)
        'device_actor_slots': 2,  # stacked parameter slots of the chunk; pairings beyond them defer to the host fallback
        'device_actor_record': '',  # '' = auto by the twin's RNG_COMPAT; 'strict' = records verified on the host, byte for byte a worker's; 'device' = device-sampled records stamped record_version 1
    },
    'decode_cache_blocks': 1024,  # LRU capacity (bz2 blocks) of the batchers' decoded-moment cache; 0 disables
    'prefetch_depth': 2,          # batches staged to the device (pinned host memory, a copy stream) ahead of the step
    'compute_dtype': '',          # '' = float32; 'bfloat16' runs the learner's net in bf16 activations (flax's module dtype), params, grads and Adam's moments fp32
    # telemetry (telemetry.py): the registry, spans, the beacons' fleet
    # merge, tracing, the flight recorder, alerts, the Prometheus
    # exporter. A bool (the collection switch) or a block of
    # telemetry.TELEMETRY_DEFAULTS' keys: enabled, trace_dir (or
    # HANDYRL_TPU_TRACE, which wins), trace_sample_rate, blackbox_dir,
    # recorder_events, metrics_rotate_mb, alerts, perf_plane, retrace,
    # retrace_warmup_epochs
    'telemetry': True,            # collect metrics (near-zero cost off; also HANDYRL_TPU_TELEMETRY=0)
    'telemetry_port': 0,          # serve Prometheus text (/metrics) and /statusz on this port (0 = exporter off; a busy port retries, then an ephemeral one is taken and logged)
    'profile_epochs': '',         # epochs to wrap in a torch.profiler trace with CUDA activity ('3', '2,5', '3-5'); written to <trace_dir|model_dir>/profile unless profile_dir is set
    'profile_dir': '',            # when set (and profile_epochs is not), profile 20 update steps early in training into it
    # the durable training plane (spool.EpisodeSpool, fault.LedgerJournal):
    # a SIGKILLed remote learner restarts with no admitted episode lost,
    # and surviving gathers reattach through the resume-token handshake
    'durability': {
        'spool': True,            # WAL every admitted episode (and streamed chunk) under model_dir/spool/ before it is counted (remote learners only); a restart replays the records past the newest checkpoint's consumption horizon
        'segment_mb': 64,         # spool segment rotation size (MB); only the live segment can hold a torn tail
        'keep_segments': 2,       # closed segments kept past the GC horizon (GC at each epoch sync)
        'ledger_snapshot': True,  # persist the TaskLedger book (ledger.snap at each epoch, ledger.delta.wal between), so a restarted learner re-issues stranded tasks with their original sample_keys
    },
    # streaming partial-episode ingest (streaming.ChunkAssembler): workers
    # and the device actor flush fixed-T window chunks of in-flight
    # episodes through the upload path; off is the whole-episode path
    'streaming': {
        'enabled': False,         # flush in-flight episodes as fixed-T chunks (remote 'g' tasks); the final chunk carries the outcome
        'chunk_steps': 32,        # plies a chunk (T); a multiple of compress_steps, so chunk blocks land on the whole-episode block grid
        'staleness_half_life': 0.0,  # seconds after which a sampled window's selection weight halves (its chunk's receive age); 0 = off (the sampler's draws unchanged)
        'max_reselect': 4,        # re-draws before a stale window is accepted regardless
        'target_clip': 0.0,       # IMPACT clipped target network: V-trace rhos from a lagged target policy, clipped at this ceiling; 0 = off (independent of streaming.enabled)
        'target_sync_epochs': 1,  # epochs between target refreshes from the live params (target_clip > 0)
    },
    # league training (league.py): PFSP opponents over the registry's
    # versions and anchors, persistent Elo ratings, and a rating-gated
    # promotion in place of serving.auto_promote (the worker plane only)
    'league': {
        'enabled': False,        # the worker plane's 'g' tasks seat PFSP-drawn pool members and a slice of 'e' tasks become rating matches; requires serving.publish (the pool is the registry line). False = mirror self-play, tasks and records unchanged
        'line': '',              # registry line the pool draws members from; '' = serving.line
        'anchors': ['random'],   # built-in members without a checkpoint: 'random' (uniform legal play, in 'g' and 'e') and 'rulebase'/'rulebase-<key>' (the env's rule_based_action; 'e' rating matches only)
        'curve': 'variance',     # PFSP weight over the learner's win rate p against a member: 'variance' (p*(1-p)), 'hard' ((1-p)^hard_exponent), 'uniform'
        'hard_exponent': 2.0,    # k of the 'hard' curve's (1-p)^k
        'self_play_rate': 0.5,   # share of 'g' tasks kept as mirror self-play; the rest seat a PFSP-drawn member (a pure function of (seed, sample_key))
        'rating_match_rate': 0.25,  # share of 'e' tasks turned into rating matches against the roster in round robin
        'max_members': 8,        # newest registry versions in the member window (the champion and the rollback target always in); bounds the GC-pinned set
        'initial_rating': 1200.0,  # Elo rating every member and the learner start from
        'k_factor': 32.0,        # Elo K: the most a game moves a rating (scaled by sigma/initial_sigma with track_sigma)
        'track_sigma': True,     # TrueSkill-lite: a member's sigma shrinks with its games and scales its K
        'initial_sigma': 200.0,  # starting sigma with track_sigma
        'min_sigma': 50.0,       # sigma's floor with track_sigma
        'promote_margin': 30.0,  # the learner must clear the champion's rating by this many Elo points to be promoted
        'min_games': 20,         # the learner's rated games since the last promotion before the gate opens
        'rating_flush_seconds': 5.0,  # write the rating journal at most this often after an outcome lands (s); 0 = at the epoch's sync only
    },
}

WORKER_DEFAULTS: Dict[str, Any] = {
    'server_address': '',
    'num_parallel': 8,
    'backend': '',
}

def parse_epoch_set(spec) -> set:
    """Parse the ``profile_epochs`` knob: an int, a list of ints, or a
    comma-separated string accepting ranges ('3', '2,5', '3-5,8')."""
    if not spec:
        return set()
    if isinstance(spec, int):
        return {int(spec)}
    if isinstance(spec, (list, tuple)):
        return {int(x) for x in spec}
    out: set = set()
    for part in str(spec).split(','):
        part = part.strip()
        if not part:
            continue
        if '-' in part and not part.startswith('-'):
            lo, _, hi = part.partition('-')
            out.update(range(int(lo), int(hi) + 1))
        else:
            out.add(int(part))
    return out


# blocks of planes the port does not have yet: each turns its plane on
# when one of the named keys is set (truthy; model_parallel above 1)
NOT_PORTED_BLOCKS: Dict[str, tuple] = {
    'parallel': ('model_parallel', 'partition_rules'),
    'distributed': ('coordinator_address', 'num_processes', 'process_id'),
}
# the generation backends of a gather host
_BACKENDS = ('', 'worker', 'engine', 'device')
_RECORD_MODES = ('', 'strict', 'device')

_ENV_KEYS = ('env', 'torus_impl', 'norm_kind', 'net_kind', 'policy_head',
             'init_kind')
_ENVS = ('TicTacToe', 'ParallelTicTacToe', 'Geister', 'ConnectX',
         'HungryGeese')
# env_args.norm_kind: the JAX package's make_norm kinds a net takes
_NORM_KINDS = ('group', 'batch', 'batchstats', 'layer')
_TARGETS = ('MC', 'TD', 'VTRACE', 'UPGO')
# train_args.compute_dtype: '' and 'float32' run the params' dtype
COMPUTE_DTYPES = ('', 'float32', 'bfloat16')
# env_args.net_kind: GeeseNet ('conv') and GeeseNetLSTM ('lstm')
_NET_KINDS = ('conv', 'lstm')


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
        'env_args': dict(raw.get('env_args', {'env': 'TicTacToe'})),
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

    wa = args.get('worker_args', WORKER_DEFAULTS)
    extra = sorted(set(wa) - set(WORKER_DEFAULTS) - {'num_gathers'})
    _require(not extra, 'worker_args keys %s are not known to the port'
             % extra)
    _validate_backend('worker_args.backend', wa.get('backend'))
    _require(int(wa.get('num_parallel', 1)) >= 1,
             'worker_args.num_parallel must be >= 1')
    _require(env.get('env') in _ENVS,
             'env_args.env %r: only %s are ported' % (env.get('env'),
                                                      ', '.join(_ENVS)))
    extra = sorted(set(env) - set(_ENV_KEYS))
    _require(not extra, 'env_args keys %s are not known to the port' % extra)
    _require(env.get('norm_kind', 'group') in _NORM_KINDS,
             'env_args.norm_kind %r must be one of %s'
             % (env.get('norm_kind'), ', '.join(_NORM_KINDS)))
    _require(env.get('norm_kind', 'group') == 'group'
             or env.get('torus_impl', 'pad') != 'pallas',
             "env_args.torus_impl 'pallas' runs norm_kind 'group' only "
             '(the trunk kernel is GroupNorm)')
    _require(env.get('policy_head', 'dense') in ('dense', 'spatial'),
             "env_args.policy_head must be 'dense' or 'spatial'")
    _require(env.get('init_kind', 'flax') in ('flax', 'torch'),
             "env_args.init_kind must be 'flax' or 'torch'")
    _require(env.get('net_kind', 'conv') in _NET_KINDS,
             'env_args.net_kind %r: only %s are ported; the other nets %s'
             % (env.get('net_kind'), ' and '.join(_NET_KINDS), pending))
    _require(env.get('torus_impl', 'pad') in ('pad', 'halo', 'pallas'),
             'env_args.torus_impl %r is unknown' % (env.get('torus_impl'),))

    extra = sorted(set(ta) - set(TRAIN_DEFAULTS) - set(NOT_PORTED_BLOCKS)
                   - {'env'})
    _require(not extra, 'train_args keys %s: the port\'s learner does not '
             'run them; the parts they configure %s' % (extra, pending))
    for key, switches in NOT_PORTED_BLOCKS.items():
        block = ta.get(key) or {}
        on = [k for k in switches if block.get(k)
              and not (k == 'model_parallel' and int(block[k]) == 1)]
        _require(not on, 'train_args.%s.%s: the %s plane %s'
                 % (key, on[0] if on else '', key, pending))
    _validate_generation(ta, env, wa)
    _validate_inference(ta)
    _require(isinstance(ta['batched_generation'], bool),
             'train_args.batched_generation must be true or false')
    # device_generation with batched_generation false (or --server) is the
    # worker plane, which never reads device_generation (handyrl_tpu/
    # train.py:1228-1236, :2551): the gathers' backend comes from
    # generation.backend or worker_args.backend alone
    _validate_worker_plane(ta)
    _require(not ta['batcher_shared_memory'] or ta['batcher_processes'],
             'train_args.batcher_shared_memory requires batcher_processes '
             '(the thread batchers already share the trainer\'s memory)')
    _validate_device_path(ta)
    _require(int(ta['burn_in_steps']) >= 0, 'burn_in_steps must be >= 0')
    _require(ta['compute_dtype'] in COMPUTE_DTYPES,
             'train_args.compute_dtype %r: the port runs %s'
             % (ta['compute_dtype'], ', '.join(repr(d) for d in
                                               COMPUTE_DTYPES)))
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
    _require(int(ta['keep_checkpoints'] or 0) >= 0,
             'keep_checkpoints must be >= 0 (0 keeps every checkpoint)')
    srv = ta['serving']
    extra = sorted(set(srv) - set(TRAIN_DEFAULTS['serving']))
    _require(not extra, 'serving keys %s: the learner\'s serving block '
             'takes %s; the service reads its own args (serving_args)'
             % (extra, sorted(TRAIN_DEFAULTS['serving'])))
    _require(bool(str(srv['line'] or '').strip()),
             'serving.line must be a non-empty model-line name')
    _validate_tiers(srv)
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
    _validate_telemetry(ta)
    _validate_durable_plane(ta)
    _validate_league(ta)


def _validate_telemetry_block(tel) -> bool:
    """The ``telemetry`` block or bool alone (the serving tier's entry
    points take it too); True when collection is on."""
    _require(isinstance(tel, (bool, dict)),
             'telemetry must be a bool or a block (enabled / trace_dir / '
             'trace_sample_rate / blackbox_dir / recorder_events / '
             'metrics_rotate_mb / alerts / perf_plane / retrace / '
             'retrace_warmup_epochs)')
    tel_enabled = (bool(tel.get('enabled', True)) if isinstance(tel, dict)
                   else bool(tel))
    if isinstance(tel, dict):
        _require(0.0 <= float(tel.get('trace_sample_rate', 1.0)) <= 1.0,
                 'telemetry.trace_sample_rate must be a fraction in [0, 1]')
        _require(int(tel.get('recorder_events', 256)) >= 16,
                 'telemetry.recorder_events must be >= 16 (the '
                 'flight-recorder ring needs room for a useful postmortem '
                 'tail)')
        _require(float(tel.get('metrics_rotate_mb', 0)) >= 0,
                 'telemetry.metrics_rotate_mb must be >= 0 (0 disables '
                 'rotation)')
        alerts = tel.get('alerts', {})
        _require(isinstance(alerts, (bool, dict, list)),
                 'telemetry.alerts must be a block ({builtin, interval, '
                 'rules}), a rule list, or False')
        if isinstance(alerts, dict) and alerts.get('interval') is not None:
            _require(float(alerts['interval']) > 0,
                     'telemetry.alerts interval must be > 0 seconds')
        rules = alerts.get('rules') if isinstance(alerts, dict) else \
            (alerts if isinstance(alerts, list) else None)
        for rule in (rules or []):
            _require(isinstance(rule, dict) and bool(rule.get('name'))
                     and bool(rule.get('metric')),
                     'each telemetry.alerts rule needs at least name + '
                     'metric')
        _require(str(tel.get('retrace', 'warn')).lower()
                 in ('warn', 'abort', 'off'),
                 "telemetry.retrace must be 'warn', 'abort' or 'off'")
        _require(int(tel.get('retrace_warmup_epochs', 1)) >= 0,
                 'telemetry.retrace_warmup_epochs must be >= 0')
    return tel_enabled


def _validate_telemetry(ta: Dict[str, Any]) -> None:
    """The ``telemetry`` block, ``profile_epochs`` and ``telemetry_port``,
    with the JAX package's checks (handyrl_tpu/config.py:397-441)."""
    tel_enabled = _validate_telemetry_block(ta['telemetry'])
    if ta['profile_epochs']:
        epochs = parse_epoch_set(ta['profile_epochs'])
        _require(bool(epochs) and all(e >= 1 for e in epochs),
                 "profile_epochs must name epochs >= 1 ('3', '2,5', '3-5')")
    if ta['telemetry_port'] is not None:
        port = int(ta['telemetry_port'])
        _require(0 <= port <= 65535, 'telemetry_port must be a TCP port (0 '
                 'disables the exporter)')
        _require(port == 0 or tel_enabled,
                 'telemetry_port needs telemetry enabled (the exporter '
                 'serves the registry the collection switch turns off)')


def _port_ok(value, key: str, zero: str) -> None:
    _require(0 <= int(value) <= 65535,
             '%s must be a TCP port (0 = %s)' % (key, zero))


def _endpoint_ok(value, key: str) -> None:
    _host, _, port = str(value).rpartition(':')
    _require(port.isdigit() and 0 < int(port) <= 65535,
             "%s must look like 'host:port' (got %r)" % (key, value))


def validate_serving(srv: Dict[str, Any]) -> None:
    """A service's ``serving`` block (the resolver's and the gateway's
    too), with the JAX package's checks (handyrl_tpu/config.py:467-531),
    as :class:`ConfigError`."""
    # a learner's config may serve its own registry: its publish and
    # endpoint keys ride in the same block, as in the JAX package
    extra = sorted(set(srv) - set(SERVING_DEFAULTS)
                   - set(TRAIN_DEFAULTS['serving']))
    _require(not extra, 'serving keys %s are not known' % extra)
    _port_ok(srv['port'], 'serving.port', 'ephemeral')
    _require(int(srv['engines']) >= 1, 'serving.engines must be >= 1')
    _require(int(srv['max_clients']) >= 1,
             'serving.max_clients must be >= 1')
    _require(float(srv['drain_timeout']) > 0,
             'serving.drain_timeout must be > 0')
    _require(bool(str(srv['line'] or '').strip()),
             'serving.line must be a non-empty model-line name')
    _require(float(srv['lock_timeout']) > 0,
             'serving.lock_timeout must be > 0')
    _validate_tiers(srv)


def _validate_tiers(srv: Dict[str, Any]) -> None:
    """``serving.metrics_port`` and the ``fleet`` and ``gateway`` blocks,
    with the JAX package's checks (handyrl_tpu/config.py:463-531). Each
    ``metrics_port`` is a TCP port, 0 turning that tier's exporter off."""
    for block, defaults in (('fleet', FLEET_DEFAULTS),
                            ('gateway', GATEWAY_DEFAULTS)):
        _require(isinstance(srv[block], dict),
                 'serving.%s must be a block of %s'
                 % (block, ', '.join(defaults)))
        extra = sorted(set(srv[block]) - set(defaults))
        _require(not extra, 'serving.%s keys %s are not known'
                 % (block, extra))
    flt, gw = srv['fleet'], srv['gateway']
    for key, value in (('serving.metrics_port', srv['metrics_port']),
                       ('serving.fleet.metrics_port', flt['metrics_port']),
                       ('serving.gateway.metrics_port', gw['metrics_port'])):
        _port_ok(value, key, 'exporter off')
    for key in ('heartbeat_interval', 'heartbeat_timeout', 'refresh_interval',
                'breach_window', 'idle_window', 'quarantine_period'):
        _require(float(flt[key]) > 0, 'serving.fleet.%s must be > 0' % key)
    _require(float(flt['heartbeat_timeout'])
             > float(flt['heartbeat_interval']),
             'serving.fleet.heartbeat_timeout must exceed heartbeat_interval '
             'or every live replica is quarantined between beacons')
    _port_ok(flt['port'], 'serving.fleet.port', 'ephemeral')
    _require(int(flt['replicas']) >= 0, 'serving.fleet.replicas must be >= 0 '
             '(0 = external replicas only)')
    _require(int(flt['min_replicas']) >= 1,
             'serving.fleet.min_replicas must be >= 1')
    _require(int(flt['max_replicas']) >= int(flt['min_replicas']),
             'serving.fleet.max_replicas must be >= min_replicas')
    _require(float(flt['slo_p99_ms']) >= 0, 'serving.fleet.slo_p99_ms must '
             'be >= 0 (0 = breach on sheds only)')
    if flt['resolver']:
        _endpoint_ok(flt['resolver'], 'serving.fleet.resolver')
    _port_ok(gw['port'], 'serving.gateway.port', 'ephemeral')
    _require(int(gw['workers']) >= 1, 'serving.gateway.workers must be >= 1')
    _require(int(gw['max_sessions']) >= 1,
             'serving.gateway.max_sessions must be >= 1')
    for key in ('ply_timeout', 'monitor_interval', 'session_timeout'):
        _require(float(gw[key]) > 0, 'serving.gateway.%s must be > 0' % key)
    if gw['resolver']:
        _endpoint_ok(gw['resolver'], 'serving.gateway.resolver')


def _validate_league(ta: Dict[str, Any]) -> None:
    """The ``league`` block, with the JAX package's checks
    (handyrl_tpu/config.py:532-562)."""
    lg = ta['league']
    _require(isinstance(lg, dict), 'league must be a block of %s'
             % ', '.join(TRAIN_DEFAULTS['league']))
    extra = sorted(set(lg) - set(TRAIN_DEFAULTS['league']))
    _require(not extra, 'train_args.league keys %s are not known' % extra)
    _require(str(lg['curve']) in ('variance', 'hard', 'uniform'),
             "league.curve must be 'variance', 'hard' or 'uniform'")
    _require(float(lg['hard_exponent']) > 0,
             'league.hard_exponent must be > 0')
    for key in ('self_play_rate', 'rating_match_rate'):
        _require(0.0 <= float(lg[key]) <= 1.0,
                 'league.%s must be a fraction in [0, 1]' % key)
    _require(int(lg['max_members']) >= 1, 'league.max_members must be >= 1')
    _require(float(lg['k_factor']) > 0, 'league.k_factor must be > 0')
    _require(float(lg['promote_margin']) >= 0,
             'league.promote_margin must be >= 0')
    _require(int(lg['min_games']) >= 1, 'league.min_games must be >= 1')
    _require(float(lg['initial_sigma']) >= float(lg['min_sigma']) > 0,
             'league.initial_sigma and league.min_sigma: the sigma bounds '
             'need initial_sigma >= min_sigma > 0')
    _require(float(lg['rating_flush_seconds']) >= 0,
             'league.rating_flush_seconds must be >= 0 (0 = the epoch '
             'sync\'s flushes only)')
    for anchor in (lg['anchors'] or []):
        _require(anchor == 'random' or str(anchor).startswith('rulebase'),
                 "league.anchors entries must be 'random' or "
                 "'rulebase[-key]' (got %r)" % (anchor,))
    _require(not lg['enabled'] or ta['serving']['publish'],
             'league.enabled requires serving.publish (the pool\'s members '
             'are the registry line\'s versions)')


def _validate_durable_plane(ta: Dict[str, Any]) -> None:
    """The ``durability`` and ``streaming`` blocks, with the JAX
    package's checks (handyrl_tpu/config.py:361-388)."""
    for block in ('durability', 'streaming'):
        _require(isinstance(ta[block], dict), '%s must be a block of %s'
                 % (block, ', '.join(TRAIN_DEFAULTS[block])))
        extra = sorted(set(ta[block]) - set(TRAIN_DEFAULTS[block]))
        _require(not extra, 'train_args.%s keys %s are not known'
                 % (block, extra))
    dur, stm = ta['durability'], ta['streaming']
    _require(float(dur['segment_mb']) > 0,
             'durability.segment_mb must be > 0')
    _require(int(dur['keep_segments']) >= 0,
             'durability.keep_segments must be >= 0 (0 = GC every closed '
             'segment past the horizon)')
    _require(int(stm['chunk_steps']) >= 1,
             'streaming.chunk_steps must be >= 1')
    _require(int(stm['chunk_steps']) % int(ta['compress_steps']) == 0,
             'streaming.chunk_steps must be a multiple of compress_steps so '
             'chunk-local bz2 blocks align with the whole-episode block grid')
    _require(float(stm['staleness_half_life']) >= 0,
             'streaming.staleness_half_life must be >= 0 (0 = off)')
    _require(int(stm['max_reselect']) >= 1,
             'streaming.max_reselect must be >= 1')
    _require(float(stm['target_clip']) >= 0,
             'streaming.target_clip must be >= 0 (0 = no target network)')
    _require(int(stm['target_sync_epochs']) >= 1,
             'streaming.target_sync_epochs must be >= 1')


def _validate_backend(key: str, backend) -> None:
    _require(str(backend or '') in _BACKENDS, '%s must be one of %s'
             % (key, _BACKENDS))


def _validate_inference(ta: Dict[str, Any]) -> None:
    """The ``inference`` block and ``serving.endpoint``, with the JAX
    package's checks (handyrl_tpu/config.py:445-460, :477-482)."""
    inf = ta['inference']
    _require(isinstance(inf, dict), 'inference must be a block of %s'
             % ', '.join(TRAIN_DEFAULTS['inference']))
    extra = sorted(set(inf) - set(TRAIN_DEFAULTS['inference']))
    _require(not extra, 'train_args.inference keys %s are not known' % extra)
    _require(str(inf['engine_backend']) in ('cpu', 'device'),
             "inference.engine_backend must be 'cpu' or 'device'")
    _require(float(inf['batch_wait_ms']) >= 0,
             'inference.batch_wait_ms must be >= 0 (0 = dispatch immediately)')
    _require(int(inf['max_batch']) >= 1, 'inference.max_batch must be >= 1')
    _require(int(inf['vault_size']) >= 1, 'inference.vault_size must be >= 1')
    _require(int(inf['queue_max']) >= 0,
             'inference.queue_max must be >= 0 (0 = unbounded)')
    _require(int(inf['request_retries']) >= 0,
             'inference.request_retries must be >= 0')
    for key in ('stall_timeout', 'restart_max_delay', 'request_timeout',
                'reprobe_initial_delay', 'reprobe_max_delay'):
        _require(inf[key] is None or float(inf[key]) > 0,
                 'inference.%s must be > 0' % key)
    endpoint = str(ta['serving']['endpoint'] or '')
    for one in filter(None, (e.strip() for e in endpoint.split(','))):
        _host, _, port = one.rpartition(':')
        _require(port.isdigit() and 0 < int(port) <= 65535,
                 "serving.endpoint entries must look like 'host:port' "
                 '(got %r)' % one)


def _validate_generation(ta: Dict[str, Any], env: Dict[str, Any],
                         wa: Dict[str, Any]) -> None:
    """The ``generation`` block, with the JAX package's checks
    (handyrl_tpu/config.py:568-577), and the device backend's need for a
    tensor twin of the env."""
    gen = ta['generation']
    extra = sorted(set(gen) - set(TRAIN_DEFAULTS['generation']))
    _require(not extra, 'train_args.generation keys %s are not known'
             % extra)
    _validate_backend('train_args.generation.backend', gen.get('backend'))
    for key in ('device_actor_envs', 'device_actor_chunk_steps',
                'device_actor_slots'):
        _require(int(gen[key]) >= 1, 'train_args.generation.%s must be >= 1'
                 % key)
    _require(str(gen['device_actor_record'] or '') in _RECORD_MODES,
             "train_args.generation.device_actor_record must be '', "
             "'strict' or 'device'")
    from .environment import DEVICE_ENVS
    for key, backend in (('train_args.generation.backend', gen['backend']),
                         ('worker_args.backend', wa.get('backend'))):
        _require(str(backend or '') != 'device'
                 or env.get('env') in DEVICE_ENVS,
                 "%s 'device': env %r has no tensor twin "
                 '(environment.DEVICE_ENVS)' % (key, env.get('env')))


def _validate_worker_plane(ta: Dict[str, Any]) -> None:
    """The local cluster's size and the fault-tolerance knobs (each > 0;
    the liveness deadline above the heartbeat period), as the JAX package
    checks them."""
    w = ta['worker']
    extra = sorted(set(w) - {'num_parallel', 'num_gathers'})
    _require(not extra, 'train_args.worker keys %s are not known' % extra)
    for key in ('num_parallel', 'num_gathers'):
        _require(w.get(key) is None or int(w[key]) >= 1,
                 'train_args.worker.%s must be >= 1' % key)
    ft = ta['fault_tolerance']
    extra = sorted(set(ft) - set(TRAIN_DEFAULTS['fault_tolerance']))
    _require(not extra, 'fault_tolerance keys %s are not known' % extra)
    for key, value in ft.items():
        _require(float(value) > 0, 'fault_tolerance.%s must be > 0' % key)
    _require(float(ft['liveness_timeout']) > float(ft['heartbeat_interval']),
             'fault_tolerance.liveness_timeout must exceed '
             'heartbeat_interval, or every healthy peer is detached between '
             'beacons')


def _validate_device_path(ta: Dict[str, Any]) -> None:
    """The device knobs' ranges. Every combination of the switches runs
    (the learner picks the JAX learner's branch: the fused loop, the split
    generator, the threaded replay trainer with device or host ingest; on
    the worker plane the gathers' backend)."""
    for key in ('device_chunk_steps', 'checkpoint_interval',
                'replay_fused_steps'):
        _require(int(ta[key]) >= 1, '%s must be >= 1' % key)
    for key in ('sgd_steps_per_chunk', 'replay_windows_per_episode',
                'eval_envs'):
        _require(ta[key] is None or int(ta[key]) >= 1,
                 '%s must be None or >= 1' % key)
    _require(ta['max_sample_reuse'] is None
             or float(ta['max_sample_reuse']) > 0,
             'max_sample_reuse must be > 0 (unset it to free-spin)')
