"""The worker plane's actor side: episode workers, gathers and the cluster
fronts (the port of ``handyrl_tpu/worker.py``).

The wire is the JAX package's: the four RPCs (``args``, ``episode``,
``result``, ``model``), the entry handshake on ``ENTRY_PORT`` (the host's
``base_worker_id`` and the learner's merged config) and the data
connections on ``DATA_PORT``; frames are the data-only codec's, snapshots
flax bytes. So a worker host of either package can serve a learner of
either.

* :class:`Worker`: one process that asks for tasks and plays them,
  generation ('g') with the sequential :class:`~.generation.Generator`
  and evaluation ('e') with the sequential
  :class:`~.evaluation.Evaluator`, on models materialized per id in a
  :class:`~.inference.ModelVault` on its device. Workers run on the card
  by default: every ply of a GeeseNet is one forward at the 8-row bucket
  (kernel K1's serving form with ``torus_impl='pallas'``). In engine mode
  (``inference.enabled``, or a gather backend of 'engine') a worker holds
  no params and touches no card: its models are
  :class:`~.inference.RemoteModel` handles whose plies its
  :class:`~.inference.EngineClient` sends up the pipe (or to
  ``serving.endpoint``), with deadlines and a failover to its own forward
  on its device.
* :class:`Gather`: the relay between about 16 workers and the learner. It
  prefetches task blocks, caches snapshots per id and ships uploads in
  batches; on a socket link it redials with backoff and resends what the
  learner has not acknowledged, and beacons its stats. A gather of the
  per-worker backend relays bytes and never imports torch; in engine mode
  it owns the host's card: an :class:`~.inference.EngineSupervisor` on
  ``worker.device`` coalesces its workers' plies into batched forwards
  (K1's serving form at the tick's bucket), its snapshots fetched over the
  same server link as the task RPCs (one lock serializes them). With
  ``serving.endpoint`` or ``serving.fleet.resolver`` set it runs no
  engine.
* :class:`DeviceActorGather` (``generation.backend`` or a host's
  ``worker_args.backend`` 'device'): a gather with no workers that plays
  its task blocks as lanes of one fused rollout on its card
  (``device_generation.DeviceActorEngine``: K1's serving form once a slot
  and a ply, inside a CUDA graph), the tasks the engine defers on a host
  Generator and Evaluator in the same process.
* :class:`WorkerCluster` (local: gathers over spawned pipes, ``python -m
  handyrl_tpu_torch.train`` with ``batched_generation: false``),
  :class:`WorkerServer` (the learner's listeners, ``--server``) and
  :class:`RemoteWorkerCluster` (a worker host, ``python -m
  handyrl_tpu_torch.worker``, whose supervisor respawns gathers).

Every worker's and gather's beacon carries its process's kernel launch
counts and play stats, and a last beacon goes out at its end, so the
learner reports the launches of the whole fleet (``fleet_beacons``).
Beacons also carry the process's telemetry registry snapshot: a gather
merges its workers' into its own (``telemetry.merge_snapshots``) and
sends the merged one up, which the learner merges into its fleet view.
Every process of the plane adopts the run's telemetry config
(``telemetry.adopt_config``: run id, trace directory and rate, flight
recorder) and dumps its flight recorder on a fatal error; a worker that
loses its gather dumps ``gather-lost``, the worker host's supervisor
``gather-death`` for a gather that died. A gather writes one ``upload``
trace event an episode (stash to the learner's acknowledgement).
Children are spawned, never forked, with one OpenMP thread each
(``CHILD_ENV``): six workers with a thread per core each would thrash the
host's cores.

With the ``streaming`` block on, a worker's generation streams fixed-T
chunks (``'chunk'`` uploads) through its gather's stash, resend buffer and
last flush, and a device actor gather's engine streams its 'device'
record lanes the same way. A gather given the learner's resume token
(``resume_token``, in the entry handshake's config) presents it on every
redial (``RESUME_KIND``): a restarted learner of the same run answers ok
and the gather reattaches in place, its unacknowledged uploads resent; a
learner of another run refuses and the gather exits for a cold respawn.

A gather's beacon carries its engine's counts (requests, batches, fill
ratio, sheds, restarts by reason, the buckets K1 ran at), a worker's its
client's (timeouts, errors, failovers, re-promotions, local inferences,
stale replies).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import queue
import random
import sys
import threading
import time
import traceback
from collections import OrderedDict, defaultdict, deque
from socket import gethostname
from typing import Any, Dict, Iterable, List, Optional

from . import telemetry
from .connection import (HEARTBEAT_KIND, INFER_KIND, RESUME_KIND, Hub,
                         _bare_main,
                         accept_socket_connections, child_environ,
                         connect_socket_connection, send_recv,
                         spawn_pipe_workers)
from .fault import Backoff, parse_chaos

_LOG = telemetry.get_logger('worker')

# the well-known ports; HANDYRL_TPU_ENTRY_PORT and HANDYRL_TPU_DATA_PORT
# override them, so that several fleets (or parallel test runs) share a host
ENTRY_PORT = 9999
DATA_PORT = 9998

# the environment of every spawned gather and worker: one OpenMP thread
CHILD_ENV = {'OMP_NUM_THREADS': '1'}

# connection-death signatures on the blocking RPC paths (sockets and
# pipes); socket.timeout and the reset errors are OSErrors
_CONN_ERRORS = (OSError, EOFError, ConnectionError)


def entry_port() -> int:
    return int(os.environ.get('HANDYRL_TPU_ENTRY_PORT', ENTRY_PORT))


def data_port() -> int:
    return int(os.environ.get('HANDYRL_TPU_DATA_PORT', DATA_PORT))


class Worker:
    """One actor process: loops task requests over the 4-RPC protocol and
    plays generation ('g') or evaluation ('e') assignments on
    ``args['worker']['device']`` (default 'cuda'; without CUDA it raises
    and the process exits non-zero). In engine mode its forwards run on
    its gather's engine and on this device only after a failover."""

    def __init__(self, args: Dict[str, Any], conn, wid: int):
        from .environment import make_env
        from .evaluation import Evaluator
        from .generation import Generator
        from .inference import EngineClient, ModelVault, RemoteModelCache
        from .model import fp32_on_card, resolve_device
        telemetry.adopt_config(args)
        telemetry.set_process_label('worker-%d' % wid)
        telemetry.install_crash_dump()
        self.device = resolve_device(args['worker'].get('device', 'cuda'))
        fp32_on_card(self.device)
        _LOG.info('opened worker %d (pid %d) on %s', wid, os.getpid(),
                  self.device)
        self.worker_id = wid
        self.conn = conn
        self.env = make_env({**args['env'], 'id': wid})
        random.seed(args['seed'] + wid)
        ft = args.get('fault_tolerance') or {}
        self._hb_interval = float(ft.get('heartbeat_interval', 10.0))
        self._hb_next = time.time() + self._hb_interval
        self._hb_seq = 0
        inf = args.get('inference') or {}
        self.client: Optional[EngineClient] = None
        if inf.get('enabled'):
            # engine mode: no params here; the client owns the deadlines
            # and the failover to this process's own forward (its vault
            # then fetches snapshots through the same 'model' RPC)
            self.client = EngineClient(conn, args, namespace=wid)
            self.vault = RemoteModelCache(self.client)
        else:
            self.env.reset()
            example_obs = self.env.observation(self.env.players()[0])
            self.vault = ModelVault(
                lambda mid: send_recv(conn, ('model', mid)), example_obs,
                capacity=int(inf.get('vault_size', 3)), device=self.device)
        generator = Generator(self.env, args, namespace=wid)
        evaluator = Evaluator(self.env, args, device=self.device)
        # role -> (episode producer, upload RPC name)
        self.playbook = {'g': (generator.execute, 'episode'),
                         'e': (evaluator.execute, 'result')}
        if (args.get('streaming') or {}).get('enabled'):
            # streaming: the generator flushes chunks through the gather
            # pipe mid-episode ('chunk' uploads ride the gather's stash and
            # resend buffer); the episode's own upload becomes a streamed
            # sentinel the loop skips
            self.playbook['g'] = (
                lambda models, task: generator.execute(
                    models, task,
                    emit=lambda c: self._rpc(('chunk', c))),
                'episode')
        # what the beacons report: tasks by role; the plies and seconds of
        # generation played by a net and by model id 0 (the RandomModel:
        # no forward), and the seconds of evaluation, each without the
        # models' fetch and materialization (model_seconds)
        self.stats = {'episodes': 0, 'results': 0, 'failures': 0,
                      'plies': 0, 'generation_seconds': 0.0,
                      'random_plies': 0, 'random_seconds': 0.0,
                      'evaluation_seconds': 0.0, 'model_seconds': 0.0}

    def beacon(self) -> Dict[str, Any]:
        """This process's kernel launches, play stats and registry
        snapshot (its device-memory gauges sampled first), and in engine
        mode its client's counts."""
        from .ops import kernel_launches
        self._hb_seq += 1
        telemetry.sample_device_memory()
        info = {'worker': self.worker_id, 'pid': os.getpid(),
                'seq': self._hb_seq, 'device': str(self.device),
                'launches': kernel_launches(), 'stats': dict(self.stats),
                'telemetry': telemetry.snapshot()}
        if self.client is not None:
            info['engine_client'] = dict(self.client.stats,
                                         engine_ok=self.client.engine_ok)
        return info

    def _rpc(self, msg):
        """One call-response on the gather pipe; in engine mode through the
        client, which absorbs a late inference reply instead of taking it
        for this RPC's answer."""
        if self.client is not None:
            return self.client.rpc(msg)
        return send_recv(self.conn, msg)

    def _maybe_heartbeat(self, final: bool = False):
        now = time.time()
        if not final and (self._hb_interval <= 0 or now < self._hb_next):
            return
        self._hb_next = now + self._hb_interval
        self.conn.send((HEARTBEAT_KIND, self.beacon()))
        # the shared trace file stays current while this worker lives: a
        # killed gather's workers must not strand their episodes' spans
        telemetry.trace_flush()

    def run(self):
        """The task loop: a broken pipe to the gather ends the process; a
        crashing episode costs that episode only (its payload becomes
        None, and the learner's ledger re-issues the task on deadline)."""
        chaos = parse_chaos()
        doom = None
        if chaos.get('kill_worker'):
            rng = random.Random(int(chaos.get('seed', 0)) * 7919
                                + self.worker_id)
            doom = time.time() + rng.expovariate(1.0 / chaos['kill_worker'])
        while True:
            if doom is not None and time.time() >= doom:
                print('chaos: worker %d self-destructing' % self.worker_id,
                      flush=True)
                os._exit(17)
            try:
                self._maybe_heartbeat()
                task = self._rpc(('args', None))
                if task is None:   # the run is over: the last beacon
                    self._maybe_heartbeat(final=True)
                    return
            except _CONN_ERRORS:
                self._gather_lost()
                return
            if task.get('role') == 'idle':
                # the learner withholds fresh tasks from this host
                # (draining or quarantined): nap and ask again
                telemetry.counter('worker_idle_tasks_total').inc()
                time.sleep(min(5.0, float(task.get('wait', 1.0))))
                continue
            produce, upload_as = self.playbook[task['role']]
            t0 = t1 = time.perf_counter()
            models: Dict[Any, Any] = {}
            try:
                models = self.vault.obtain(dict(task.get('model_id', {})))
                t1 = time.perf_counter()
                payload = produce(models, task)
            except _CONN_ERRORS:       # the model fetch rode the dead pipe
                self._gather_lost()
                return
            except Exception:
                traceback.print_exc()
                payload = None
                self.stats['failures'] += 1
                telemetry.counter('worker_task_failures_total').inc()
            self.stats['model_seconds'] += t1 - t0
            dt = time.perf_counter() - t1
            telemetry.counter('worker_tasks_total', role=task['role']).inc()
            telemetry.histogram('worker_task_seconds', role=task['role']
                                ).observe(dt + t1 - t0)
            if task['role'] == 'g':
                net = any(_plays_a_net(m) for m in models.values())
                self.stats['generation_seconds' if net
                           else 'random_seconds'] += dt
                if payload is not None:
                    self.stats['episodes'] += 1
                    self.stats['plies' if net else 'random_plies'] += int(
                        payload['steps'])
            else:
                self.stats['evaluation_seconds'] += dt
                self.stats['results'] += payload is not None
            if isinstance(payload, dict) and payload.get('streamed'):
                continue   # every window already rode the pipe
            try:
                self._rpc((upload_as, payload))
            except _CONN_ERRORS:
                self._gather_lost()
                return

    def _gather_lost(self):
        """The pipe to the gather died: leave a blackbox dump (the
        post-mortem's evidence of which side died first) and exit; the
        gather's supervisor owns respawns."""
        _LOG.warning('worker %d: lost its gather; exiting', self.worker_id)
        telemetry.record_event('guard', 'gather connection lost',
                               worker=self.worker_id)
        telemetry.dump_blackbox('gather-lost', worker=self.worker_id)


def _plays_a_net(model) -> bool:
    """Whether a seat's model runs a forward: a materialized net, or an
    engine handle of any id but 0 (the RandomModel)."""
    if model is None:
        return False
    if hasattr(model, 'batch_inference'):
        return True
    return getattr(model, 'model_id', 0) != 0


def open_worker(args, conn, wid):
    """A worker process's entry point."""
    import torch
    torch.set_num_threads(1)
    Worker(args, conn, wid).run()


def _shard(total: int, parts: int, index: int) -> int:
    """Size of shard ``index`` when ``total`` items split across ``parts``."""
    return total // parts + (1 if index < total % parts else 0)


def latest_beacons(infos: Iterable[Any], key: str) -> Dict[tuple, dict]:
    """The newest beacon of each process among heartbeat payloads (the
    entries with ``key``), by (``key``, pid): a process's counts only
    grow, and a gather that redialed shows up under two endpoints."""
    out: Dict[tuple, dict] = {}
    for info in infos:
        if not isinstance(info, dict) or key not in info:
            continue
        k = (info[key], info.get('pid'))
        if k not in out or info.get('seq', 0) >= out[k].get('seq', 0):
            out[k] = info
    return out


def beacon_soft_faults(info: Dict[str, Any]) -> int:
    """A gather beacon's soft faults: its engine's restarts and its
    workers' failovers to their own forward, each a count that only
    grows while the processes live."""
    faults = int((info.get('engine') or {}).get('restarts', 0))
    for w in info.get('workers') or ():
        faults += int((w.get('engine_client') or {}).get('failovers', 0))
    return faults


class UploadTrace:
    """A gather's ``upload`` trace events: one an episode (or chunk), from
    its stash in the upload box to the learner's acknowledgement of the
    batch. Only sampled trace ids are tracked (the decision every other
    hop makes), at most :attr:`MAX_PER_KIND` a kind, so a long outage
    cannot grow the book past the resend buffer's order."""

    MAX_PER_KIND = 512

    def __init__(self, gather_id: int):
        self.gather_id = int(gather_id)
        self._box: Dict[str, list] = defaultdict(list)

    def stash(self, kind: str, payload):
        if not telemetry.trace_enabled():
            return
        tid = telemetry.episode_trace_id((payload or {}).get('args') or {})
        if tid and telemetry.trace_sampled(tid):
            box = self._box[kind]
            if len(box) < self.MAX_PER_KIND:
                box.append((tid, time.time()))

    def shipped(self, kind: str):
        """The learner acknowledged this kind's batch: one event a tracked
        payload, over its whole stay in the relay."""
        entries = self._box.pop(kind, None)
        if not entries:
            return
        now = time.time()
        for tid, t0 in entries:
            telemetry.trace_event('upload', ts=t0, dur=now - t0,
                                  trace_id=tid, kind=kind,
                                  gather=self.gather_id)
        telemetry.trace_flush()


class Gather:
    """Fan-in relay between its workers and the learner.

    Amortizes server round trips: task assignments are prefetched in
    blocks, model snapshots are served from a per-id cache, and episode and
    result uploads are shipped in batches.

    On a socket link (``reconnect`` given) every server RPC is supervised:
    a failure closes the link, redials the data port with exponential
    backoff and jitter, and resends the same RPC, so the upload box
    survives a severed link (the learner's ledger drops a resent
    duplicate). A daemon thread sends one-way heartbeat beacons with this
    relay's stats and its workers' newest beacons; the last one goes out
    when the relay ends, on a pipe too.

    When every worker was lost before it was told the run is over (a
    ``None`` task), :attr:`lost` is set and the relay's process exits
    non-zero."""

    SNAP_SLOTS = 4                   # snapshots cached per relay

    def __init__(self, args: Dict[str, Any], server_conn, gather_id: int,
                 reconnect=None):
        _LOG.info('started gather %d (pid %d)', gather_id, os.getpid())
        telemetry.adopt_config(args)
        telemetry.set_process_label('gather-%d' % gather_id)
        telemetry.install_crash_dump()
        self.gather_id = gather_id
        self._upload_trace = UploadTrace(gather_id)
        gid = str(gather_id)
        self._m_uploads = {kind: telemetry.counter(
            'gather_uploads_total', gather=gid, kind=kind)
            for kind in ('episode', 'result', 'chunk')}
        self._m_retries = telemetry.counter('gather_rpc_retries_total',
                                            gather=gid)
        self._m_reconnects = telemetry.counter('gather_reconnects_total',
                                               gather=gid)
        self._m_dropped = telemetry.counter('gather_dropped_uploads_total',
                                            gather=gid)
        self._m_box_depth = telemetry.gauge('gather_upload_box_depth',
                                            gather=gid)
        self._m_eps_rate = telemetry.gauge('gather_episodes_per_sec',
                                           gather=gid)
        self._m_resend_dropped = telemetry.counter(
            'gather_resend_dropped_total', gather=gid)
        self._m_reattach = telemetry.counter('gather_reattach_total',
                                             gather=gid)
        ft = args.get('fault_tolerance') or {}
        self._reconnect_fn = reconnect
        self._rpc_timeout = float(ft.get('rpc_timeout', 120.0))
        self._hb_interval = float(ft.get('heartbeat_interval', 10.0))
        self._backoff_initial = float(ft.get('reconnect_initial_delay', 1.0))
        self._backoff_max = float(ft.get('reconnect_max_delay', 30.0))
        self._max_tries = int(ft.get('reconnect_max_tries', 30))
        self._resend_max = int(ft.get('resend_buffer', 256))
        # the durable learner's resume token (in the entry handshake's
        # config): presented on every redial, so a restarted learner of the
        # same run keeps this gather instead of it respawning
        self._resume_token = dict(args.get('resume_token') or {})
        self.stats = {'reconnects': 0, 'dropped_uploads': 0,
                      'reattaches': 0}
        self._hb_seq = 0
        self.hub: Optional[Hub] = None
        if server_conn is None and reconnect is not None:
            server_conn = reconnect()   # the child dials (respawn-friendly)
        self.server = server_conn
        if getattr(server_conn, 'sock', None) is not None:
            # a silently dead server must fail the blocking recv
            server_conn.sock.settimeout(self._rpc_timeout)
            if self._hb_interval > 0:
                threading.Thread(target=self._heartbeat_loop,
                                 name='gather-%d-heartbeat' % gather_id,
                                 daemon=True).start()

        n_total = args['worker']['num_parallel']
        n_relays = args['worker']['num_gathers']
        n_here = _shard(n_total, n_relays, gather_id)
        first_wid = args['worker'].get('base_worker_id', 0)

        def worker_args(i, child_conn):
            return (args, child_conn, first_wid + i * n_relays + gather_id)

        # the engine thread fetches snapshots through the same server link
        # as the main loop's RPCs: one lock keeps their frames apart
        self._rpc_lock = threading.RLock()
        self.hub = Hub()
        self.engine = None
        inf = args.get('inference') or {}
        srv = args.get('serving') or {}
        # remote mode: an endpoint list, or a fleet resolver whose replica
        # table the workers' EngineClient fetches itself
        endpoint = srv.get('endpoint') or (srv.get('fleet') or {}).get(
            'resolver')
        if inf.get('enabled') and endpoint:
            # the workers dial the service themselves; the 'model' RPC
            # stays for a degraded worker
            _LOG.info('gather %d: inference routed to the service at %s; '
                      'no local engine', gather_id, endpoint)
        elif inf.get('enabled'):
            from .inference import EngineSupervisor, warm_up
            from .model import fp32_on_card, resolve_device
            device = resolve_device(args['worker'].get('device', 'cuda'))
            fp32_on_card(device)
            warm_up(device)
            self.engine = EngineSupervisor(
                args, fetch_snapshot=self._snapshot,
                reply_fn=lambda ep, msg: self.hub.send(ep, (INFER_KIND, msg)),
                clients=n_here, device=device)
            _LOG.info('gather %d: inference engine on %s for %d workers',
                      gather_id, device, n_here)
        self.workers = spawn_pipe_workers(n_here, open_worker, worker_args,
                                          env=CHILD_ENV)
        for _, ep in self.workers:
            self.hub.attach(ep)
        self.block = 1 + n_here // 4          # round-trip amortization
        self._task_stock: deque = deque()
        self._snap_cache: OrderedDict = OrderedDict()
        self._upload_box: Dict[str, list] = defaultdict(list)
        self._upload_count = 0
        self._finished = 0                    # workers told the run is over
        self.lost = False

    # -- supervised server link --

    def beacon(self) -> Dict[str, Any]:
        """This relay's stats, its workers' newest beacons (of the live
        ones and of those that have gone) and one telemetry snapshot:
        this process's merged with its workers' (``merge_snapshots``), a
        departed worker's without its gauges (its counts stay in the
        fleet's sums, its levels are gone with it)."""
        self._hb_seq += 1
        live: List[Any] = []
        gone: List[Any] = []
        hub = getattr(self, 'hub', None)   # beacons start before the hub
        if hub is not None:
            live = list(hub.peer_info_snapshot().values())
            gone = list(hub.departed_peer_info().values())
        live_keys = set(latest_beacons(live, 'worker'))
        telemetry.sample_device_memory()
        snaps = [telemetry.snapshot()]
        workers = []
        for key, w in latest_beacons(live + gone, 'worker').items():
            w = dict(w)
            snap = w.pop('telemetry', None)
            if isinstance(snap, dict):
                snaps.append(snap if key in live_keys
                             else dict(snap, gauges={}))
            workers.append(w)
        info = {'gather': self.gather_id, 'pid': os.getpid(),
                'seq': self._hb_seq, **self.stats, 'workers': workers,
                'telemetry': telemetry.merge_snapshots(snaps)}
        engine = getattr(self, 'engine', None)
        if engine is not None:
            from .ops import kernel_launches
            info['engine'] = dict(engine.stats(), launches=kernel_launches())
        return info

    def _heartbeat_loop(self):
        """One-way beacons, sent even while the main loop blocks inside a
        long RPC (the learner busy at an epoch boundary), with a freshly
        computed episodes/s gauge."""
        last_n, last_t = 0, time.time()
        while True:
            time.sleep(self._hb_interval)
            now = time.time()
            n = self._m_uploads['episode'].value
            self._m_eps_rate.set((n - last_n) / max(now - last_t, 1e-9))
            last_n, last_t = n, now
            try:
                self.server.send((HEARTBEAT_KIND, self.beacon()))
            except Exception:
                pass   # the RPC path owns failure handling and reconnect
            telemetry.trace_flush()   # keep the shared trace file current

    def _recover(self, exc: Exception):
        """Redial the data port with exponential backoff and jitter; runs
        inside :meth:`_server_rpc`, under ``_rpc_lock``."""
        _LOG.warning('gather %d: server link lost (%s: %s); reconnecting',
                     self.gather_id, type(exc).__name__, str(exc)[:120])
        try:
            self.server.close()
        except Exception:
            pass
        backoff = Backoff(self._backoff_initial, self._backoff_max)
        last_err: Optional[Exception] = exc
        for _ in range(self._max_tries):
            time.sleep(backoff.next_delay())
            try:
                conn = self._reconnect_fn()
            except OSError as e:
                last_err = e
                continue
            conn.sock.settimeout(self._rpc_timeout)
            if self._resume_token and not self._present_token(conn):
                continue
            self.server = conn
            self.stats['reconnects'] += 1
            self._m_reconnects.inc()
            _LOG.warning('gather %d: reconnected to the server',
                         self.gather_id)
            return
        raise ConnectionError(
            'gather %d: could not re-reach the server after %d tries (%s)'
            % (self.gather_id, self._max_tries, last_err))

    def _present_token(self, conn) -> bool:
        """The resume-token handshake on a fresh link: True when the
        learner recognized the run (a changed generation is a reattach
        across its restart), False when the link died first. A learner
        that refuses the token is another run: raise, so the gather exits
        and its supervisor respawns it cold."""
        try:
            reply = send_recv(conn, (RESUME_KIND, dict(
                self._resume_token, gather=self.gather_id)))
        except _CONN_ERRORS:
            try:
                conn.close()
            except Exception:
                pass
            return False
        if not (isinstance(reply, dict) and reply.get('ok')):
            try:
                conn.close()
            except Exception:
                pass
            raise ConnectionError(
                'gather %d: learner rejected the resume token (run over or '
                'replaced); cold respawn required' % self.gather_id)
        gen = int(reply.get('generation',
                            self._resume_token.get('generation', 0)))
        if gen != int(self._resume_token.get('generation', 0)):
            self._resume_token['generation'] = gen
            self.stats['reattaches'] += 1
            self._m_reattach.inc()
            _LOG.warning('gather %d: reattached across a learner restart '
                         '(generation %d)', self.gather_id, gen)
        return True

    def _server_rpc(self, msg):
        """send_recv with supervised reconnect: the request is resent on
        the fresh link (the server drops a duplicate by task_id). Under
        ``_rpc_lock``: the engine thread's snapshot fetches share the link,
        and two interleaved call-responses would cross their replies. The
        beacon thread's sends interleave whole frames
        (``FramedConnection.send`` locks)."""
        with self._rpc_lock:
            while True:
                try:
                    return send_recv(self.server, msg)
                except _CONN_ERRORS as exc:
                    if self._reconnect_fn is None:   # a pipe: unrecoverable
                        raise
                    self._m_retries.inc()
                    self._recover(exc)

    # -- per-RPC handling --

    def _next_task(self):
        if not self._task_stock:
            self._task_stock.extend(
                self._server_rpc(('args', [None] * self.block)))
        return self._task_stock.popleft()

    def _snapshot(self, mid):
        """Per-id snapshot LRU: one epoch's params an entry, bounded (the
        epoch grows for the life of the run). Serves the workers' 'model'
        RPCs and the engine thread's fetches, under ``_rpc_lock``."""
        with self._rpc_lock:
            if mid not in self._snap_cache:
                while len(self._snap_cache) >= self.SNAP_SLOTS:
                    self._snap_cache.popitem(last=False)
                self._snap_cache[mid] = self._server_rpc(('model', mid))
            self._snap_cache.move_to_end(mid)
            return self._snap_cache[mid]

    def _ship(self, kind: str):
        self._server_rpc((kind, self._upload_box[kind]))
        del self._upload_box[kind]   # acked: booked by the learner
        self._upload_trace.shipped(kind)

    def _stash_upload(self, kind: str, payload):
        self._upload_box[kind].append(payload)
        self._upload_trace.stash(kind, payload)
        self._upload_count += 1
        if kind in self._m_uploads:
            self._m_uploads[kind].inc()
        while self._upload_count > self._resend_max:
            # a bounded resend buffer: in a long outage keep the newest
            # uploads and count what was dropped
            biggest = max(self._upload_box,
                          key=lambda k: len(self._upload_box[k]))
            self._upload_box[biggest].pop(0)
            self._upload_count -= 1
            self.stats['dropped_uploads'] += 1
            self._m_dropped.inc()
            self._m_resend_dropped.inc()
            _LOG.warning('gather %d: resend buffer full (%d); dropped a %r '
                         'upload', self.gather_id, self._resend_max, biggest)
        if self._upload_count >= self.block:
            for kind in list(self._upload_box):
                self._ship(kind)
            self._upload_count = 0
        self._m_box_depth.set(self._upload_count)

    def run(self):
        while self.hub.count() > 0:
            try:
                ep, (kind, body) = self.hub.recv(timeout=0.3)
            except queue.Empty:
                continue
            if kind == 'args':
                task = self._next_task()
                self._finished += task is None
                self.hub.send(ep, task)
            elif kind == 'model':
                self.hub.send(ep, self._snapshot(body))
            elif kind == INFER_KIND:
                if self.engine is None:
                    self.hub.send(ep, (INFER_KIND, {
                        'rid': (body or {}).get('rid'), 'engine_fault': True,
                        'error': 'inference engine disabled on this host'}))
                else:
                    self.engine.submit(ep, body)
            else:
                self.hub.send(ep, None)       # ack now, ship in bulk later
                self._stash_upload(kind, body)
        if self._finished == 0:
            codes = []
            for proc, _ in self.workers:
                proc.join(5.0)
                codes.append(proc.exitcode)
            self.lost = True
            _LOG.error('gather %d: all %d of its workers were lost before '
                       'the run ended (exit codes %s)', self.gather_id,
                       len(self.workers), codes)
        self._flush_and_beacon()
        for proc, _ in self.workers:
            proc.join(5.0)

    def _flush_and_beacon(self):
        """The relay's end: ship the last partial upload block, stop the
        engine and send a last beacon, so the learner sees this relay's
        complete counts."""
        for kind in list(self._upload_box):
            if self._upload_box[kind]:
                self._ship(kind)
        self._upload_box.clear()
        if self.engine is not None:
            self.engine.stop()
        try:
            self.server.send((HEARTBEAT_KIND, self.beacon()))
        except Exception:
            pass   # the run is over; a dead link changes nothing


def resolve_generation_backend(args: Dict[str, Any]) -> str:
    """The actor engine of a gather host: 'worker' (per-worker inference),
    'engine' (the per-host :class:`~.inference.EngineSupervisor` on the
    gather's card) or 'device' (the fused rollout on the gather's card,
    :class:`DeviceActorGather`). A host's ``worker_args.backend`` (riding
    the entry handshake) wins over the training config's
    ``generation.backend``; with neither set, 'engine' when the inference
    block is on, else 'worker' (the JAX package's rule)."""
    backend = str((args.get('worker') or {}).get('backend') or ''
                  ) or str((args.get('generation') or {}).get('backend')
                           or '')
    if not backend:
        backend = ('engine' if (args.get('inference') or {}).get('enabled')
                   else 'worker')
    return backend


class DeviceActorGather(Gather):
    """A gather whose lanes of one fused device rollout stand in for its
    workers (the JAX package's ``DeviceActorGather``, worker.py:657-741
    there). With streaming on, the engine's 'device' record lanes stream
    their windows into the upload box as ``'chunk'`` uploads.

    It keeps all of :class:`Gather`'s learner side (the supervised server
    RPC with reconnect, the task-block prefetch, the snapshot cache, the
    batched upload box with its resend bound, the beacons) with zero
    worker children, and serves its task blocks with a
    :class:`~.device_generation.DeviceActorEngine` on ``worker.device``
    (default 'cuda'; without CUDA it raises and the process exits
    non-zero). Tasks the engine defers run on a host
    :class:`~.generation.Generator` / :class:`~.evaluation.Evaluator` pair
    in this process (their forwards on the same device), so every task is
    answered either way. Its beacon carries the engine's counts
    (``device_actor``)."""

    def __init__(self, args: Dict[str, Any], server_conn, gather_id: int,
                 reconnect=None):
        from .device_generation import DeviceActorEngine
        from .environment import make_device_env, make_env
        from .evaluation import Evaluator
        from .generation import Generator
        from .inference import ModelVault
        from .model import fp32_on_card, resolve_device
        self.device = resolve_device(args['worker'].get('device', 'cuda'))
        fp32_on_card(self.device)
        doctored = dict(args)
        doctored['worker'] = dict(args['worker'], num_parallel=0)
        doctored['inference'] = dict(args.get('inference') or {},
                                     enabled=False)
        super().__init__(doctored, server_conn, gather_id,
                         reconnect=reconnect)
        gen = args.get('generation') or {}
        n_envs = int(gen.get('device_actor_envs', 64))
        slots = int(gen.get('device_actor_slots', 2))
        self.block = max(1, n_envs // 4)      # task-prefetch granularity
        self.host_env = make_env(args['env'])
        self.host_env.reset()
        example_obs = self.host_env.observation(self.host_env.players()[0])
        self.vault = ModelVault(self._snapshot, example_obs,
                                capacity=slots + 2, device=self.device)
        self.device_engine = DeviceActorEngine(
            make_device_env(args['env']), self.vault, self.host_env, args,
            n_envs=n_envs,
            chunk_steps=int(gen.get('device_actor_chunk_steps', 16)),
            slots=slots,
            record_mode=str(gen.get('device_actor_record', '') or ''),
            seed=int(args.get('seed', 0)) * 1009 + gather_id,
            device=self.device)
        if (args.get('streaming') or {}).get('enabled'):
            # streamed windows ride the upload box like whole episodes (the
            # resend buffer, the reconnect replay and the last flush)
            self.device_engine.emit = lambda c: self._stash_upload('chunk', c)
        self._fallback_gen = Generator(self.host_env, args,
                                       namespace=gather_id)
        self._fallback_eval = Evaluator(self.host_env, args,
                                        device=self.device)
        self.stats['deferred'] = 0
        self.stats['host_failures'] = 0
        self._m_deferred = telemetry.counter('device_actor_deferred_total')
        _LOG.info('gather %d: device actor backend on %s (%d lanes, %d '
                  'slots, %s records)', gather_id, self.device, n_envs,
                  slots, self.device_engine.record_mode)

    def beacon(self) -> Dict[str, Any]:
        from .ops import kernel_launches
        info = super().beacon()
        eng = getattr(self, 'device_engine', None)
        if eng is None:           # a beacon before the engine was built
            return info
        info['device_actor'] = dict(
            eng.stats, deferred=self.stats['deferred'],
            host_failures=self.stats['host_failures'], blocks=eng.blocks,
            fill_ratio=(eng.stats['plies']
                        / max(1, eng.stats['scheduled_plies'])),
            builds=eng.builds, graph_captures=eng.captures,
            record_mode=eng.record_mode, device=str(self.device),
            launches=kernel_launches())
        return info

    def _collect_block(self):
        """Pull up to one lane-count of tasks; returns (tasks, stop)."""
        tasks: List[dict] = []
        while len(tasks) < self.device_engine.n_envs:
            task = self._next_task()
            if task is None:
                return tasks, True
            if task.get('role') == 'idle':
                if tasks:
                    return tasks, False   # serve the partial block now
                telemetry.counter('worker_idle_tasks_total').inc()
                time.sleep(min(5.0, float(task.get('wait', 1.0))))
                continue
            tasks.append(task)
        return tasks, False

    def _run_host(self, task):
        """The host fallback for a task the engine deferred, with a
        worker's payload contract; a crash costs that task (None: the
        ledger re-issues it)."""
        self.stats['deferred'] += 1
        self._m_deferred.inc()
        kind = 'result' if task.get('role') == 'e' else 'episode'
        try:
            models = self.vault.obtain(dict(task.get('model_id', {})))
            with telemetry.expected_compile('device-actor host fallback'):
                if task.get('role') == 'e':
                    payload = self._fallback_eval.execute(models, task)
                else:
                    payload = self._fallback_gen.execute(models, task)
        except _CONN_ERRORS:
            raise                 # the model fetch rode a dead pipe
        except Exception:
            traceback.print_exc()
            payload = None
            self.stats['host_failures'] += 1
            telemetry.counter('worker_task_failures_total').inc()
        self._stash_upload(kind, payload)

    def run(self):
        while True:
            tasks, stop = self._collect_block()
            if tasks:
                uploads, deferred = self.device_engine.run_block(tasks)
                for kind, payload in uploads:
                    self._stash_upload(kind, payload)
                for task in deferred:
                    self._run_host(task)
            if stop:
                break
        self._flush_and_beacon()


def gather_loop(args, conn, gather_id, server_address=None):
    """A gather process's entry point: pipe mode (``conn`` given) or
    socket mode (it dials ``server_address``'s data port itself). The
    backend ``resolve_generation_backend`` names picks the relay: a
    :class:`Gather` of worker processes (with the host's inference engine
    for 'engine'), or a :class:`DeviceActorGather`; a host's backend turns
    the inference block on or off to match. Exits 1 when every worker was
    lost before the run ended."""
    backend = resolve_generation_backend(args)
    if backend not in ('worker', 'engine', 'device'):
        raise ValueError('generation backend %r is unknown' % backend)
    inf = args.get('inference') or {}
    if backend == 'worker' and inf.get('enabled'):
        # a host's override demoted this gather to plain workers: they
        # materialize their own params instead of dialing an engine
        args = dict(args, inference=dict(inf, enabled=False))
    elif backend == 'engine' and not inf.get('enabled'):
        args = dict(args, inference=dict(inf, enabled=True))
    reconnect = None
    if server_address:
        def reconnect():
            return connect_socket_connection(server_address, data_port())
    if backend == 'device':
        import torch
        torch.set_num_threads(1)
        DeviceActorGather(args, conn, gather_id, reconnect=reconnect).run()
        return
    if backend == 'engine':
        import torch
        torch.set_num_threads(1)
    gather = Gather(args, conn, gather_id, reconnect=reconnect)
    try:
        gather.run()
    except BaseException:
        # a gather that fails (the server gone for good, or a refused
        # resume token) ends its workers first: at exit, multiprocessing
        # would join them while they wait on this gather's pipes
        for proc, _ in gather.workers:
            proc.terminate()
        raise
    if gather.lost:
        raise SystemExit(1)


def default_num_gathers(num_parallel: int) -> int:
    return 1 + max(0, num_parallel - 1) // 16


class WorkerCluster:
    """Local mode: gather processes over spawned pipes, one hub in the
    learner. ``recv``/``send``/``connection_count`` delegate to the hub,
    so the learner's server loop does not care about the transport.

    Unlike the JAX package's cluster, which leaves the learner waiting
    once every gather is gone, :meth:`lost_gathers` names the gathers that
    exited non-zero, and the learner stops with exit 1."""

    def __init__(self, args: Dict[str, Any]):
        self.args = args
        self.hub = Hub()
        ft = args.get('fault_tolerance') or {}
        self.hub.LIVENESS_TIMEOUT = float(
            ft.get('liveness_timeout', Hub.LIVENESS_TIMEOUT))
        self.procs: List[Any] = []

    def connection_count(self) -> int:
        return self.hub.count()

    def recv(self, timeout: Optional[float] = None):
        return self.hub.recv(timeout=timeout)

    def send(self, conn, data):
        self.hub.send(conn, data)

    def hub_stats(self) -> Dict[str, int]:
        return self.hub.stats_snapshot()

    def drain_detach_events(self):
        return self.hub.drain_detach_events()

    def peer_info(self) -> Dict[Any, Any]:
        """The newest beacon of each live peer, by endpoint."""
        return self.hub.peer_info_snapshot()

    def fleet_beacons(self) -> Dict[str, Dict[tuple, dict]]:
        """The newest beacon of every gather and of every worker process
        this learner has heard of, live or gone."""
        infos = (list(self.hub.peer_info_snapshot().values())
                 + list(self.hub.departed_peer_info().values()))
        gathers = latest_beacons(infos, 'gather')
        workers = latest_beacons(
            [w for g in gathers.values() for w in g.get('workers', ())],
            'worker')
        return {'gathers': gathers, 'workers': workers}

    def run(self):
        wargs = self.args['worker']
        wargs.setdefault('num_gathers',
                         default_num_gathers(wargs['num_parallel']))
        for proc, ep in spawn_pipe_workers(
                wargs['num_gathers'], gather_loop,
                lambda i, c: (self.args, c, i), env=CHILD_ENV):
            self.procs.append(proc)
            self.hub.attach(ep)

    def _names(self, procs) -> str:
        return ', '.join('gather %d (pid %s, exit code %s)'
                         % (self.procs.index(p), p.pid, p.exitcode)
                         for p in procs)

    def lost(self, ending: bool) -> Optional[str]:
        """Why the cluster can no longer serve the run, naming the gathers:
        a gather exited non-zero (every worker of it was lost), or every
        gather is gone while the run is not ``ending``; else None."""
        failed = [p for p in self.procs if p.exitcode not in (None, 0)]
        if failed:
            return 'lost %s' % self._names(failed)
        if self.procs and not ending and self.hub.count() == 0:
            for p in self.procs:
                p.join(5.0)   # their exit codes, for the message
            return ('every gather left before the run ended: %s'
                    % self._names(self.procs))
        return None

    def close(self, timeout: float = 30.0):
        """Join the gathers (their workers end first); terminate the ones
        still running after ``timeout``."""
        deadline = time.monotonic() + timeout
        for proc in self.procs:
            proc.join(max(0.0, deadline - time.monotonic()))
            if proc.is_alive():
                _LOG.warning('gather pid %s did not exit; terminating',
                             proc.pid)
                proc.terminate()
                proc.join(5.0)


class WorkerServer(WorkerCluster):
    """Remote mode, learner side: two listener threads. The entry port
    hands each arriving host its ``base_worker_id`` and the merged config;
    the data port attaches accepted sockets to the hub. Hosts may join or
    leave at any time, so no gather counts as lost here."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__(args)
        self._next_base_wid = 0
        self.entry_port = entry_port()
        self.data_port = data_port()
        self._closed = False

    def _entry_loop(self):
        _LOG.info('started entry server %d', self.entry_port)
        for conn in accept_socket_connections(self.entry_port, timeout=0.5):
            if self._closed:
                return
            if conn is None:
                continue
            try:
                host_args = conn.recv()
                _LOG.info('accepted connection from %s!',
                          host_args['address'])
                host_args['base_worker_id'] = self._next_base_wid
                self._next_base_wid += host_args['num_parallel']
                merged = dict(self.args)
                merged['worker'] = host_args
                conn.send(merged)
            except (OSError, KeyError, TypeError) as exc:
                _LOG.warning('entry handshake failed (%s: %s)',
                             type(exc).__name__, str(exc)[:120])
            finally:
                conn.close()

    def _data_loop(self):
        _LOG.info('started worker server %d', self.data_port)
        for conn in accept_socket_connections(self.data_port, timeout=0.5):
            if self._closed:
                return
            if conn is not None:
                self.hub.attach(conn)

    def run(self):
        for loop in (self._entry_loop, self._data_loop):
            threading.Thread(target=loop, name=loop.__name__.strip('_'),
                             daemon=True).start()

    def lost(self, ending: bool) -> Optional[str]:
        return None

    def close(self, timeout: float = 30.0):
        self._closed = True


def entry(worker_args, retries: int = 30, delay: float = 2.0):
    """The entry handshake, retried with backoff and jitter (the learner
    may still be starting when a host comes up)."""
    last_err: Optional[Exception] = None
    port = entry_port()
    backoff = Backoff(delay, maximum=4 * delay)
    for _ in range(retries):
        try:
            conn = connect_socket_connection(
                worker_args['server_address'], port)
            try:
                conn.send(worker_args)
                return conn.recv()
            finally:
                conn.close()
        except (OSError, ConnectionResetError) as e:
            last_err = e
            time.sleep(backoff.next_delay())
    raise ConnectionError('could not reach training server at %s:%d (%s)'
                          % (worker_args['server_address'], port, last_err))


class RemoteWorkerCluster:
    """Remote mode, worker-host side: the entry handshake, then one data
    socket per gather, each dialed by its own spawned process, under a
    supervisor that respawns crashed gathers (with per-slot backoff). A
    gather that exits 0 (the learner handed out a ``None`` task: training
    is over) is retired, so the host ends when the run ends.

    ``HANDYRL_TPU_CHAOS=kill_gather=<mean s>[,max_kills=N][,seed=S]`` arms
    a fault injector that SIGKILLs random gathers on an exponential clock.
    """

    RESPAWN_RESET_AFTER = 60.0   # alive this long: the backoff resets

    def __init__(self, args: Dict[str, Any]):
        args['address'] = gethostname()
        args.setdefault('num_gathers',
                        default_num_gathers(args['num_parallel']))
        self.args = args
        self.abandoned: List[int] = []   # slots given up after max respawns
        self.respawns = 0

    def run(self):
        merged = entry(self.args)
        telemetry.adopt_config(merged)
        telemetry.set_process_label('worker-host')
        telemetry.install_crash_dump()
        _LOG.info('joined run as %s (base_worker_id %s, %s gathers)',
                  self.args['address'],
                  merged['worker'].get('base_worker_id'),
                  self.args['num_gathers'])
        ctx = mp.get_context('spawn')
        address = self.args['server_address']
        ft = merged.get('fault_tolerance') or {}
        max_fails = int(ft.get('reconnect_max_tries', 30))

        chaos = parse_chaos()
        rng = random.Random(int(chaos.get('seed', 0)))
        kills_left = int(chaos.get('max_kills', 1 << 30))
        next_kill = None
        if chaos.get('kill_gather'):
            next_kill = time.time() + rng.expovariate(
                1.0 / chaos['kill_gather'])

        def spawn(i):
            # the gather dials the data port itself: a respawn needs no
            # socket of the parent's
            proc = ctx.Process(target=gather_loop,
                               args=(merged, None, i, address))
            with _bare_main(), child_environ(CHILD_ENV):
                proc.start()
            return proc

        n = self.args['num_gathers']
        children = {i: spawn(i) for i in range(n)}
        started_at = {i: time.time() for i in children}
        backoffs = {i: Backoff(float(ft.get('reconnect_initial_delay', 1.0)),
                               float(ft.get('reconnect_max_delay', 30.0)))
                    for i in children}
        fails = {i: 0 for i in children}
        try:
            while children:
                time.sleep(0.5)
                now = time.time()
                if next_kill is not None and now >= next_kill:
                    if kills_left > 0:
                        live = [i for i, p in children.items()
                                if p.is_alive()]
                        if live:
                            victim = rng.choice(live)
                            print('chaos: killing gather %d' % victim,
                                  flush=True)
                            children[victim].kill()
                            kills_left -= 1
                    next_kill = now + rng.expovariate(
                        1.0 / chaos['kill_gather'])
                for i, proc in list(children.items()):
                    if proc.is_alive():
                        if (fails[i] and now - started_at[i]
                                > self.RESPAWN_RESET_AFTER):
                            fails[i] = 0
                            backoffs[i].reset()
                        continue
                    if proc.exitcode == 0:
                        del children[i]   # a clean exit: training ended
                        continue
                    fails[i] += 1
                    if fails[i] > max_fails:
                        _LOG.error('gather %d: giving up after %d failed '
                                   'respawns', i, fails[i] - 1)
                        self.abandoned.append(i)
                        del children[i]
                        continue
                    delay = backoffs[i].next_delay()
                    _LOG.warning('gather %d died (exit %s); respawning '
                                 'in %.1fs', i, proc.exitcode, delay)
                    print('supervisor: gather %d died (exit %s); respawning'
                          % (i, proc.exitcode), flush=True)
                    # the gather had no chance to dump (a SIGKILL): the
                    # supervisor records the evidence for the post-mortem
                    telemetry.record_event(
                        'supervisor', 'gather %d died' % i,
                        exitcode=proc.exitcode, respawn_in=round(delay, 2))
                    telemetry.dump_blackbox('gather-death', gather=i,
                                            exitcode=proc.exitcode)
                    time.sleep(delay)
                    children[i] = spawn(i)
                    self.respawns += 1
                    started_at[i] = time.time()
        finally:
            for proc in children.values():
                if proc.is_alive():
                    proc.terminate()
                proc.join(5.0)


def worker_main(args: Dict[str, Any], argv: List[str]) -> int:
    """A worker host: ``args['worker_args']`` (``num_parallel`` from the
    first of ``argv`` when given); 1 when a gather slot was given up."""
    worker_args = args['worker_args']
    if len(argv) >= 1:
        worker_args['num_parallel'] = int(argv[0])
    cluster = RemoteWorkerCluster(args=worker_args)
    cluster.run()
    print('worker host: %d gather respawns, %d slots given up'
          % (cluster.respawns, len(cluster.abandoned)), flush=True)
    return 1 if cluster.abandoned else 0


def main(argv=None) -> int:
    from .config import apply_defaults
    from .model import resolve_device
    ap = argparse.ArgumentParser(
        prog='python -m handyrl_tpu_torch.worker',
        description='a worker host: join a learner started with '
        '`python -m handyrl_tpu_torch.train --server` and play its tasks')
    ap.add_argument('--config', required=True,
                    help='JSON file with env_args, train_args and '
                    "worker_args (server_address, num_parallel; backend "
                    "'engine' for the host's inference engine, 'device' for "
                    "device actor gathers)")
    ap.add_argument('num_parallel', nargs='?', type=int, default=None,
                    help='worker processes on this host (default: '
                    'worker_args.num_parallel)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu': where this host's "
                    'workers (or its gathers\' engines, or device actor '
                    'gathers) run their models')
    a = ap.parse_args(argv)
    with open(a.config) as f:
        args = apply_defaults(json.load(f))
    # the host's workers run on this device; without CUDA it raises here,
    # before the host joins
    args['worker_args']['device'] = str(resolve_device(a.device))
    return worker_main(args, [] if a.num_parallel is None
                       else [str(a.num_parallel)])


if __name__ == '__main__':
    # run the named module's main, so that the spawned gathers find their
    # entry point by its module name (they see a bare __main__)
    from handyrl_tpu_torch import worker as _named
    sys.exit(_named.main())
