"""What the port's engine tests share: real Hungry Geese and TicTacToe
requests, the two packages' wrappers on one set of weights, loopback pipes
that carry engine frames through pickle as the gather's pipes do, and
polling helpers. Inputs come from seeds; the port's wrappers are built
from the JAX package's snapshots (the port reads them)."""

import os
import pickle
import queue
import random
import time
from collections import deque

import jax
import jax.numpy as jnp
import torch

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models.geese import GeeseNet as JaxGeeseNet
from handyrl_tpu.models.geese import GeeseNetLSTM as JaxGeeseNetLSTM
from handyrl_tpu_torch import telemetry
from handyrl_tpu_torch.connection import INFER_KIND
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.generation import sample_seed
from handyrl_tpu_torch.model import ModelWrapper

# GeeseNet at a CPU test's size: the JAX side runs its Pallas trunk in
# interpret mode, the port its trunk kernel's plain version
GEESE_NET = dict(layers=2, filters=16, torus_impl='pallas')
TOL = 1e-5      # fp32 on both sides, other summation orders in the trunk
GEN_ARGS = {'observation': False, 'gamma': 0.8, 'compress_steps': 4,
            'seed': 11}


def one_torch_thread():
    """A fixture body: one intra-op thread here and in the processes a
    test starts (the workers of a parallel test run share the cores)."""
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


def blackbox_in(directory):
    """A fixture body: the port's blackbox dumps (a supervisor's restart
    writes one) go to ``directory``, not to the working directory's
    ``blackbox``; the setting is put back after."""
    before = telemetry._BLACKBOX_DIR
    env = os.environ.get('HANDYRL_TPU_BLACKBOX')
    telemetry.configure_recorder(None, str(directory), force=True)
    yield
    telemetry.configure_recorder(None, before, force=True)
    if env is None:
        os.environ.pop('HANDYRL_TPU_BLACKBOX', None)
    else:
        os.environ['HANDYRL_TPU_BLACKBOX'] = env


def geese_plies(count, seed=0):
    """(obs, legal, seed sequence) of ``count`` real requests: four geese a
    ply of a seeded random game, the reversal left out of ``legal``."""
    env = make_env({'env': 'HungryGeese', 'id': seed})
    rng = random.Random(seed)
    last, out, ply = {}, [], 0
    while len(out) < count:
        if env.terminal():
            env.reset()
            last = {}
        actions = {}
        for p in env.turns():
            legal = [a for a in range(4) if a != {0: 1, 1: 0, 2: 3, 3: 2}
                     .get(last.get(p))]
            out.append((env.observation(p), legal,
                        sample_seed(seed, (7, p), ply)))
            actions[p] = rng.choice(legal)
        env.step(actions)
        last.update(actions)
        ply += 1
    return out[:count]


def geese_wrappers(lstm=False, seed=3):
    """(JAX wrapper, port wrapper on the CPU) with the same weights: the
    full-width trunk cut to GEESE_NET (GeeseNetLSTM at filters 8)."""
    obs = geese_plies(1)[0][0]
    if lstm:
        jw = JaxModelWrapper(JaxGeeseNetLSTM(filters=8, stem_layers=1),
                             seed=seed)
        jw.ensure_params(obs)
    else:
        net = JaxGeeseNet(**GEESE_NET)
        jw = JaxModelWrapper(net, net.init(jax.random.PRNGKey(seed),
                                           jnp.asarray(obs)[None]))
    return jw, ModelWrapper.from_snapshot(jw.snapshot(), device='cpu')


def ttt_wrappers(seed=7):
    """(env, JAX wrapper, port wrapper on the CPU) of TicTacToe's
    SimpleConv2dModel with the same weights."""
    env = jax_make_env({'env': 'TicTacToe'})
    env.reset()
    jw = JaxModelWrapper(env.net(), seed=seed)
    jw.ensure_params(env.observation(0))
    port_env = make_env({'env': 'TicTacToe'})
    port_env.reset()
    return (port_env, jw,
            ModelWrapper.from_snapshot(jw.snapshot(), device='cpu'))


class Sink:
    """A reply endpoint when an engine or supervisor is driven directly."""

    def __init__(self):
        self.replies: queue.Queue = queue.Queue()


def sink_reply(ep, msg):
    ep.replies.put(msg)


class Loopback:
    """A worker's view of its gather pipe: engine frames go into a live
    engine, replies come back as ``(INFER_KIND, reply)`` frames, both
    through pickle as over a multiprocessing pipe (fresh dtype instances
    and all). ``drop_after``/``drop_until`` lose the engine frames in that
    range of sends (a dead engine: their replies never come); the 'model'
    RPC serves ``snapshots`` as the gather does, which is what a degraded
    worker fetches through. The JAX package's frames are the same kind,
    so its clients ride it too."""

    def __init__(self, engine, snapshots=None):
        self.engine = engine
        self.snapshots = snapshots or {}
        self.drop_infer = False
        self.drop_after = None
        self.drop_until = None
        self.infer_sent = 0
        self.model_fetches = 0
        self.replies: queue.Queue = queue.Queue()
        self._peeked: deque = deque()
        self._rpc_replies: deque = deque()

    def send(self, msg):
        if msg[0] == INFER_KIND:
            self.infer_sent += 1
            dropped = self.drop_infer or (
                self.drop_after is not None
                and self.infer_sent > self.drop_after
                and (self.drop_until is None
                     or self.infer_sent <= self.drop_until))
            if not dropped and self.engine is not None:
                self.engine.submit(self, pickle.loads(pickle.dumps(msg[1])))
            return
        kind, body = msg
        assert kind == 'model', 'unexpected worker RPC %r' % (kind,)
        self.model_fetches += 1
        self._rpc_replies.append(pickle.loads(pickle.dumps(
            self.snapshots[body])))

    def poll(self, timeout=0.0):
        if self._peeked:
            return True
        try:
            self._peeked.append(self.replies.get(timeout=max(timeout, 1e-4)))
        except queue.Empty:
            return False
        return True

    def recv(self):
        if self._peeked:
            body = self._peeked.popleft()
        elif not self.replies.empty():
            body = self.replies.get()
        elif self._rpc_replies:
            return self._rpc_replies.popleft()
        else:
            body = self.replies.get(timeout=30)
        return (INFER_KIND, pickle.loads(pickle.dumps(body)))


def act_request(rid, obs, mid=1, legal=(0, 1, 2)):
    return {'rid': rid, 'mid': mid, 'obs': obs, 'hidden': None,
            'legal': list(legal), 'seed': sample_seed(11, (0, rid), 0)}


def wait_for(predicate, timeout, poll=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(poll)
    return predicate()
