"""The league in the port (handyrl_tpu_torch/league.py, the learner's
league hooks in handyrl_tpu_torch/train.py, the ``league`` block of
handyrl_tpu_torch/config.py) against the JAX package's
(handyrl_tpu/league.py, handyrl_tpu/train.py:1297-1325, 1639-1716,
2153-2270, 3205-3262, handyrl_tpu/config.py:214-234, 532-562), after its
tests/test_league.py; and F6, the registry root of ``python -m
handyrl_tpu_torch --serve --config FILE``.

All of it is host float arithmetic and seeded draws, so every comparison
is exact (tolerance 0): the PFSP weights and the draws over 1,000 sample
keys on one registry written by the JAX ``ModelRegistry`` and refreshed
by both pools; the rating book's states through the same updates, with
sigma on and off, and its journal's bytes in both directions; the
promotion gate and the learner's epoch sync; the config grid (the port's
refusals a ``ConfigError`` naming the key); 200 tasks of the port's
``_fresh_task`` against the JAX ``server()`` loop driven by a fake
worker, and a ledger re-issue of them. Then the worker side: the
``model`` reply's registry fallback, the GC's pins, the Evaluator with a
stamped member or anchor, and ``DeviceActorEngine._classify`` of stamped
tasks against the JAX engine's."""

import copy
import json
import os
import queue

import numpy as np
import pytest
import torch

from handyrl_tpu import league as jax_league
from handyrl_tpu import device_generation as jdg
from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.environment import make_jax_env
from handyrl_tpu.inference import ModelVault as JaxModelVault
from handyrl_tpu.serving.registry import ModelRegistry as JaxModelRegistry
from handyrl_tpu.train import Learner as JaxLearner
from handyrl_tpu.utils.fs import checksummed_write_bytes as jax_write
from handyrl_tpu_torch import __main__ as cli
from handyrl_tpu_torch import device_generation as dg
from handyrl_tpu_torch import league
from handyrl_tpu_torch.config import ConfigError, apply_defaults
from handyrl_tpu_torch.environment import make_device_env, make_env
from handyrl_tpu_torch.evaluation import Evaluator
from handyrl_tpu_torch.fault import TaskLedger
from handyrl_tpu_torch.inference import ModelVault
from handyrl_tpu_torch.model import ModelWrapper, params_bytes
from handyrl_tpu_torch.serving import service
from handyrl_tpu_torch.serving.registry import ModelRegistry
from handyrl_tpu_torch.train import Learner
from handyrl_tpu_torch.utils.fs import checksummed_write_bytes

pytestmark = pytest.mark.timeout(120)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The workers of a parallel test run share the cores: one intra-op
    thread a process (and in the processes a test starts, through
    OMP_NUM_THREADS) keeps these runs' many small ops from waiting on
    descheduled OpenMP threads (tens of times slower without it)."""
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


LINE = 'default'
CURVES = [('variance', 2.0), ('hard', 2.0), ('hard', 4.0), ('uniform', 2.0)]


def _league_args(**over):
    """The league block with the defaults of both packages (equal)."""
    jax_lg = jax_apply_defaults({'env_args': {'env': 'TicTacToe'}})[
        'train_args']['league']
    port_lg = apply_defaults({'env_args': {'env': 'TicTacToe'}})[
        'train_args']['league']
    assert jax_lg == port_lg
    out = dict(port_lg)
    out.update(over)
    return out


def _registry(root, versions, champion=None):
    """A registry written by the JAX ModelRegistry: ``versions`` of LINE
    published by path (each a checksummed file), the first the champion
    unless ``champion`` names another (promoted after)."""
    os.makedirs(str(root), exist_ok=True)
    reg = JaxModelRegistry(str(root))
    for v in versions:
        path = os.path.join(str(root), '%d.ckpt' % v)
        jax_write(path, b'ckpt-%d' % v)
        reg.publish(LINE, path=path, architecture='SimpleConv2dModel',
                    version=v, promote=(v == versions[0]))
    if champion is not None:
        reg.promote(LINE, champion)
    return reg


def _pools(root, versions, champion=None, **over):
    """(JAX pool, port pool) refreshed from the same manifest, the JAX
    pool through the JAX registry, the port's through the port's."""
    _registry(root, versions, champion)
    args = _league_args(**over)
    jpool = jax_league.LeaguePool(args, LINE)
    jpool.refresh(JaxModelRegistry(str(root)))
    ppool = league.LeaguePool(args, LINE)
    ppool.refresh(ModelRegistry(str(root)))
    return jpool, ppool


def _play_books(rng, names, n, track_sigma=True):
    """(JAX book, port book) after the same ``n`` random games of the
    learner against ``names``."""
    jbook = jax_league.RatingBook(track_sigma=track_sigma)
    pbook = league.RatingBook(track_sigma=track_sigma)
    for _ in range(n):
        name = names[int(rng.integers(len(names)))]
        score = float(rng.choice([0.0, 0.5, 1.0]))
        jbook.record(name, score)
        pbook.record(name, score)
    return jbook, pbook


# ------------------------------------------------------------------- PFSP

@pytest.mark.parametrize('curve,k', CURVES)
def test_pfsp_weights_equal_the_jax_packages(curve, k):
    rng = np.random.default_rng(3)
    p = np.concatenate([[0.0, 0.5, 1.0, -0.2, 1.3], rng.random(64)])
    want = jax_league.pfsp_weights(p, curve, k)
    got = league.pfsp_weights(p, curve, k)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    assert (got > 0).all()


def test_pfsp_unknown_curve_raises_as_the_jax_package():
    with pytest.raises(ValueError) as want:
        jax_league.pfsp_weights([0.5], curve='nope')
    with pytest.raises(ValueError) as got:
        league.pfsp_weights([0.5], curve='nope')
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize('name', ['default@3', 'a@b@c', 'random',
                                  'rulebase-1', 'geese@champion', '@'])
def test_member_names_split_as_in_the_jax_package(name):
    assert league.split_member(name) == jax_league.split_member(name)
    line, version = league.split_member(name)
    if line is not None:
        assert league.member_name(line, version) == name == \
            jax_league.member_name(line, version)


def test_constants_are_the_jax_packages():
    for key in ('LEAGUE_SEED_NAMESPACE', 'LEARNER', 'RANDOM_ANCHOR',
                'PFSP_CURVES', '_WEIGHT_FLOOR'):
        assert getattr(league, key) == getattr(jax_league, key), key


# --------------------------------------------------------------- the pool

@pytest.mark.parametrize('curve,k', CURVES)
@pytest.mark.parametrize('self_play_rate', [0.0, 0.5])
def test_sample_opponent_draws_equal_the_jax_packages(tmp_path, curve, k,
                                                      self_play_rate):
    """1,000 sample keys, member for member, with a book whose win rates
    differ by member (so each curve's weights differ)."""
    jpool, ppool = _pools(tmp_path, [1, 2, 3, 4, 5], champion=2,
                          curve=curve, hard_exponent=k,
                          self_play_rate=self_play_rate)
    assert ppool.gen_candidates() == jpool.gen_candidates()
    rng = np.random.default_rng(7)
    jbook, pbook = _play_books(rng, ppool.gen_candidates(), 60)
    assert pbook.to_state() == jbook.to_state()
    want = [jpool.sample_opponent(11, key, jbook) for key in range(1000)]
    got = [ppool.sample_opponent(11, key, pbook) for key in range(1000)]
    assert got == want
    drawn = set(got) - {None}
    assert len(drawn) == len(ppool.gen_candidates())   # every one reached
    assert (None in got) == (self_play_rate > 0)


def test_rating_opponent_ids_and_candidates_equal_the_jax_packages(
        tmp_path):
    jpool, ppool = _pools(tmp_path, [1, 2, 3], anchors=['random',
                                                        'rulebase'])
    assert ppool.roster() == jpool.roster()
    assert ppool.members() == jpool.members()
    assert ppool.member_paths() == jpool.member_paths()
    assert ppool.gen_candidates() == jpool.gen_candidates() == [
        'default@1', 'default@2', 'default@3', 'random']
    assert [ppool.rating_opponent(i) for i in range(12)] == [
        jpool.rating_opponent(i) for i in range(12)]
    for name in ppool.roster() + ['default@9', 'other@1']:
        assert ppool.member_model_id(name) == jpool.member_model_id(name)
    assert ppool.member_model_id('random') == 0
    assert ppool.member_model_id('rulebase') is None
    assert ppool.champion == jpool.champion == 'default@1'
    # an empty pool: no candidate, no draw
    empty = league.LeaguePool(_league_args(anchors=[]), LINE)
    assert empty.sample_opponent(0, 0, league.RatingBook()) is None
    assert empty.rating_opponent(3) is None


def test_refresh_keeps_champion_and_previous_outside_the_window(tmp_path):
    """max_members 2 keeps the newest two; the champion (v2) and the
    rollback target (v1) stay members."""
    jpool, ppool = _pools(tmp_path, [1, 2, 3, 4, 5], champion=2,
                          max_members=2)
    assert ppool.members() == jpool.members() == [
        'default@1', 'default@2', 'default@4', 'default@5']
    assert ppool.champion == jpool.champion == 'default@2'
    assert ppool.member_paths() == jpool.member_paths()


# ---------------------------------------------------------- the rating book

def _book_ops(rng, n=80):
    """A seeded sequence of every kind of update."""
    names = ['default@1', 'default@2', 'random', 'rulebase']
    ops = [('seed', 'default@3', 1250.0),
           ('seed_provisional', 'guest', None),
           ('seed_provisional', 'guest2', 1100.0)]
    for i in range(n):
        kind = rng.integers(10)
        if kind < 6:
            ops.append(('record', names[int(rng.integers(len(names)))],
                        float(rng.choice([0.0, 0.5, 1.0, 0.3]))))
        elif kind < 8:
            ops.append(('record', 'guest', float(rng.random())))
        elif kind < 9:
            a, b = rng.choice(['guest', 'guest2', 'default@1', 'default@3'],
                              2, replace=False)
            ops.append(('record_between', str(a), str(b),
                        float(rng.choice([0.0, 1.0, 0.5]))))
        else:
            ops.append(('note_promotion',))
    return ops


def _apply(book, ops):
    for op in ops:
        getattr(book, op[0])(*op[1:])


@pytest.mark.parametrize('track_sigma', [True, False])
def test_rating_book_updates_equal_the_jax_packages(track_sigma):
    ops = _book_ops(np.random.default_rng(5))
    jbook = jax_league.RatingBook(track_sigma=track_sigma, k_factor=24.0)
    pbook = league.RatingBook(track_sigma=track_sigma, k_factor=24.0)
    _apply(jbook, ops)
    _apply(pbook, ops)
    assert pbook.to_state() == jbook.to_state()
    for name in jbook.names() + ['nobody']:
        assert pbook.rating(name) == jbook.rating(name)
        assert pbook.win_rate(name) == jbook.win_rate(name)
        assert pbook.games(name) == jbook.games(name)
        assert pbook.is_provisional(name) == jbook.is_provisional(name)
    assert pbook.games_since_promote == jbook.games_since_promote
    assert pbook.promotions == jbook.promotions > 0


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('track_sigma', [True, False])
def test_journal_loads_in_the_other_package_byte_for_byte(tmp_path, writer,
                                                          track_sigma):
    ops = _book_ops(np.random.default_rng(9))
    mods = {'jax': jax_league, 'port': league}
    reader = 'port' if writer == 'jax' else 'jax'
    src = mods[writer].make_rating_book({'track_sigma': track_sigma})
    _apply(src, ops)
    path = str(tmp_path / 'league_ratings.json')
    src.save(path)
    raw = open(path, 'rb').read()
    dst = mods[reader].make_rating_book({'track_sigma': track_sigma})
    assert dst.load(path)
    assert dst.to_state() == src.to_state()
    dst.save(str(tmp_path / 'again.json'))
    assert open(str(tmp_path / 'again.json'), 'rb').read() == raw
    # the following updates stay bit for bit the writer's
    more = _book_ops(np.random.default_rng(10), 30)
    _apply(src, more)
    _apply(dst, more)
    assert dst.to_state() == src.to_state()


@pytest.mark.parametrize('content', [None, b'', b'{"entries": {"learn',
                                     b'\xff\xfe', b'[1, 2',
                                     b'{"entries": {}, "promotions": 3}\n'])
def test_missing_or_torn_journal_loads_as_in_the_jax_package(tmp_path,
                                                             content):
    path = str(tmp_path / 'league_ratings.json')
    if content is not None:
        with open(path, 'wb') as f:
            f.write(content)
    jbook, pbook = jax_league.RatingBook(), league.RatingBook()
    jbook.record('random', 1.0)
    pbook.record('random', 1.0)
    assert pbook.load(path) == jbook.load(path)
    assert pbook.to_state() == jbook.to_state()


def test_journal_path_and_book_knobs_are_the_jax_packages():
    assert league.journal_path('/r') == jax_league.journal_path('/r')
    args = _league_args(initial_rating=1000.0, k_factor=16.0,
                        track_sigma=False, initial_sigma=120.0,
                        min_sigma=30.0)
    jbook = jax_league.make_rating_book(args)
    pbook = league.make_rating_book(args)
    assert vars(pbook) == vars(jbook)


# ------------------------------------------------------------ the gate

@pytest.mark.parametrize('games,delta,margin,min_games', [
    (4, 40.0, 30.0, 5),     # short of min_games
    (5, 40.0, 30.0, 5),     # at min_games, past the margin
    (5, 30.0, 30.0, 5),     # exactly the margin
    (5, 29.0, 30.0, 5),     # inside the margin
    (9, 0.0, 0.0, 1),       # margin 0: equal ratings promote
    (9, -0.5, 0.0, 1),      # just below
])
def test_should_promote_equals_the_jax_gate(tmp_path, games, delta, margin,
                                            min_games):
    jpool, ppool = _pools(tmp_path, [1, 2], promote_margin=margin,
                          min_games=min_games)
    books = [jax_league.RatingBook(), league.RatingBook()]
    for book in books:
        book.seed('default@1', 1200.0)
        for _ in range(games):
            book.record('random', 0.5)
        book.entry('learner')['rating'] = 1200.0 + delta
    want = jpool.should_promote(books[0])
    assert ppool.should_promote(books[1]) == want
    assert want == (games >= min_games and delta >= margin)
    ppool.champion = jpool.champion = None    # a headless line
    assert not ppool.should_promote(books[1])
    assert not jpool.should_promote(books[0])


class _JaxSyncStub:
    """The JAX learner's epoch sync over a registry (the method needs
    args, model_epoch and the league triple)."""

    def __init__(self, root, pool, book, epoch):
        self.args = {'model_dir': root, 'serving': {}}
        self._registry = None
        self._league = pool
        self._league_ratings = book
        self._league_journal = jax_league.journal_path(root)
        self._league_sampled = {}
        self.model_epoch = epoch
        self._registry_root = JaxLearner._registry_root.__get__(self)
        self._ensure_registry = JaxLearner._ensure_registry.__get__(self)
        self._league_epoch_sync = JaxLearner._league_epoch_sync.__get__(self)


class _PortSyncStub:
    """The port learner's epoch sync on the same kind of state."""

    def __init__(self, root, pool, book, epoch):
        self.args = {'serving': {}}
        self.model_dir = root
        self._registry = None
        self._league = pool
        self._league_ratings = book
        self._league_journal = league.journal_path(root)
        self.league_decisions = []
        self.model_epoch = epoch
        for name in ('_registry_root', '_ensure_registry',
                     '_league_epoch_sync'):
            setattr(self, name, getattr(Learner, name).__get__(self))


def _sync_pair(tmp_path, **over):
    stubs = []
    for pkg, mod, Stub, Reg in (
            ('jax', jax_league, _JaxSyncStub, JaxModelRegistry),
            ('port', league, _PortSyncStub, ModelRegistry)):
        root = str(tmp_path / pkg)
        _registry(root, [1, 2])
        pool = mod.LeaguePool(_league_args(**over), LINE)
        pool.refresh(Reg(root))
        stubs.append(Stub(root, pool, mod.make_rating_book(pool.args), 2))
    return stubs


def _both(stubs, fn):
    for stub in stubs:
        fn(stub._league_ratings)


def test_epoch_sync_promotes_through_the_gate_as_the_jax_sync(tmp_path):
    jax_stub, port_stub = _sync_pair(tmp_path, promote_margin=10.0,
                                     min_games=3)
    jroot, proot = (s._registry_root() for s in (jax_stub, port_stub))

    def step(book):
        book.entry('learner')['rating'] = 1300.0
        book.record('random', 1.0)
    _both((jax_stub, port_stub), step)
    for stub in (jax_stub, port_stub):
        stub._league_epoch_sync()
    # short of games: no change; the fresh member at the learner's rating
    assert ModelRegistry(proot).resolve(LINE)[0] == '1'
    assert port_stub._league_ratings.to_state() == \
        jax_stub._league_ratings.to_state()
    assert port_stub._league_ratings.rating('default@2') == \
        port_stub._league_ratings.rating('learner')

    def step2(book):
        for _ in range(3):
            book.record('random', 0.5)
        book.entry('learner')['rating'] = book.rating('default@1') + 10.0
    _both((jax_stub, port_stub), step2)
    for stub in (jax_stub, port_stub):
        stub._league_epoch_sync()
    for root in (jroot, proot):
        assert JaxModelRegistry(root).resolve(LINE)[0] == '2'
    pbook = port_stub._league_ratings
    assert pbook.to_state() == jax_stub._league_ratings.to_state()
    assert pbook.promotions == 1 and pbook.games_since_promote == 0
    assert port_stub._league.champion == 'default@2'
    # each package's journal, the same bytes
    assert open(league.journal_path(proot), 'rb').read() == \
        open(jax_league.journal_path(jroot), 'rb').read()
    # the recorded gates: the book as it stood, recomputed, the verdicts
    decisions = port_stub.league_decisions
    assert [d['promoted'] for d in decisions] == [False, True]
    for d in decisions:
        book = league.RatingBook()
        book.from_state(d['state'])
        pool = league.LeaguePool(port_stub._league.args, LINE)
        pool.champion = d['champion']
        assert pool.should_promote(book) == d['promoted']


def test_epoch_sync_refuses_inside_the_margin_as_the_jax_sync(tmp_path):
    stubs = _sync_pair(tmp_path, promote_margin=50.0, min_games=1)

    def step(book):
        book.record('random', 1.0)
        book.entry('learner')['rating'] = book.rating('default@1') + 49.0
    _both(stubs, step)
    for stub in stubs:
        stub._league_epoch_sync()
        assert ModelRegistry(stub._registry_root()).resolve(LINE)[0] == '1'
        assert stub._league_ratings.promotions == 0
    assert stubs[1]._league_ratings.to_state() == \
        stubs[0]._league_ratings.to_state()


# ------------------------------------------------------------- the config

BASE = {'serving': {'publish': True}}
GRID = [
    ({'curve': 'sideways'}, 'league.curve'),
    ({'curve': 'hard'}, None),
    ({'hard_exponent': 0.0}, 'league.hard_exponent'),
    ({'hard_exponent': 1e-3}, None),
    ({'self_play_rate': -0.01}, 'league.self_play_rate'),
    ({'self_play_rate': 1.01}, 'league.self_play_rate'),
    ({'self_play_rate': 0.0}, None),
    ({'self_play_rate': 1.0}, None),
    ({'rating_match_rate': -0.5}, 'league.rating_match_rate'),
    ({'rating_match_rate': 1.5}, 'league.rating_match_rate'),
    ({'rating_match_rate': 0.0}, None),
    ({'rating_match_rate': 1.0}, None),
    ({'max_members': 0}, 'league.max_members'),
    ({'max_members': 1}, None),
    ({'k_factor': 0.0}, 'league.k_factor'),
    ({'k_factor': 0.5}, None),
    ({'promote_margin': -1.0}, 'league.promote_margin'),
    ({'promote_margin': 0.0}, None),
    ({'min_games': 0}, 'league.min_games'),
    ({'min_games': 1}, None),
    ({'initial_sigma': 40.0}, 'league.initial_sigma'),
    ({'initial_sigma': 50.0}, None),
    ({'min_sigma': 0.0}, 'league.min_sigma'),
    ({'rating_flush_seconds': -1.0}, 'league.rating_flush_seconds'),
    ({'rating_flush_seconds': 0.0}, None),
    ({'anchors': ['lizard']}, 'league.anchors'),
    ({'anchors': ['random', 'rulebase', 'rulebase-2']}, None),
    ({'anchors': []}, None),
    ({'enabled': True}, None),
]


@pytest.mark.parametrize('over,key', GRID)
def test_league_config_grid_is_the_jax_packages(over, key):
    raw = {'env_args': {'env': 'TicTacToe'},
           'train_args': dict(copy.deepcopy(BASE), league=dict(over))}
    if key is None:
        want = jax_apply_defaults(copy.deepcopy(raw))['train_args']['league']
        got = apply_defaults(copy.deepcopy(raw))['train_args']['league']
        assert got == want
        return
    with pytest.raises(AssertionError):
        jax_apply_defaults(copy.deepcopy(raw))
    with pytest.raises(ConfigError, match=key):
        apply_defaults(copy.deepcopy(raw))


@pytest.mark.parametrize('env,train', [
    ('TicTacToe', {}),
    ('ConnectX', {}),
    ('TicTacToe', {'batched_generation': False}),
    ('HungryGeese', {'batched_generation': False,
                     'generation': {'backend': 'device'}}),
    ('Geister', {'batched_generation': False,
                 'league': {'anchors': ['random', 'rulebase']}}),
])
def test_league_enabled_needs_serving_publish_on_every_path(env, train):
    raw = {'env_args': {'env': env}, 'train_args': copy.deepcopy(train)}
    raw['train_args'].setdefault('league', {})['enabled'] = True
    with pytest.raises(AssertionError):
        jax_apply_defaults(copy.deepcopy(raw))
    with pytest.raises(ConfigError, match='league.enabled'):
        apply_defaults(copy.deepcopy(raw))
    raw['train_args']['serving'] = {'publish': True}
    assert jax_apply_defaults(copy.deepcopy(raw))['train_args']['league'][
        'enabled']
    assert apply_defaults(copy.deepcopy(raw))['train_args']['league'][
        'enabled']


def test_league_defaults_are_the_jax_packages():
    _league_args()
    with pytest.raises(ConfigError, match='league keys'):
        apply_defaults({'train_args': {'league': {'window': 3}}})


# ------------------------------------------------------ the server's stamps

class _FakeConn:
    def fileno(self):
        return 7


class _FakeWorker:
    """The JAX server's worker hub: ``n`` 'args' requests, each reply
    handed to ``on_send``, then no connection and a shutdown."""

    def __init__(self, stub, n, on_send):
        self.stub, self.left, self.on_send = stub, n, on_send
        self.conn = _FakeConn()

    def connection_count(self):
        return 1 if self.left > 0 else 0

    def drain_detach_events(self):
        return []

    def peer_info(self):
        return {}

    def recv(self, timeout=None):
        if self.left <= 0:
            self.stub.shutdown_flag = True
            raise queue.Empty
        self.left -= 1
        return self.conn, ('args', None)

    def send(self, conn, data):
        self.on_send(data)


class _Never:
    def requested(self):
        return False


def _jax_server_tasks(env_name, pool, book, n, epoch, on_task):
    """``n`` tasks of the JAX ``server()`` loop, each handed to
    ``on_task`` before the next is made."""
    stub = type('JaxServerStub', (), {})()
    stub.args = {'seed': 11, 'minimum_episodes': 10 ** 6,
                 'update_episodes': 10 ** 6, 'fault_tolerance': {},
                 'league': pool.args if pool is not None else {}}
    for name, value in (('_restored_ledger', None),
                        ('_recovered_closed_chunks', []),
                        ('_ledger_journal', None),
                        ('_durable_restored', False), ('_alerts', None),
                        ('shutdown_flag', False), ('num_results', 0),
                        ('num_episodes', 0), ('num_returned_episodes', 0),
                        ('eval_rate', 0.3), ('model_epoch', epoch),
                        ('_league', pool), ('_league_ratings', book)):
        setattr(stub, name, value)
    stub.env = jax_make_env({'env': env_name})
    stub.preempt = _Never()
    stub._poll_rollback = lambda: None
    for name in ('server', '_league_gen_opponent',
                 '_league_rating_opponent'):
        setattr(stub, name, getattr(JaxLearner, name).__get__(stub))
    tasks = []

    def on_send(task):
        task = dict(task)
        task.pop('task_id', None)
        tasks.append(task)
        on_task(task)
    stub.worker = _FakeWorker(stub, n, on_send)
    stub.server()
    return tasks


def _port_task_stub(env_name, pool, book, epoch):
    stub = type('PortServerStub', (), {})()
    stub.args = {'seed': 11}
    stub.env = make_env({'env': env_name})
    stub.num_results = stub.num_episodes = 0
    stub.eval_rate = 0.3
    stub.model_epoch = epoch
    stub._league, stub._league_ratings = pool, book
    for name in ('_fresh_task', '_league_gen_opponent',
                 '_league_rating_opponent'):
        setattr(stub, name, getattr(Learner, name).__get__(stub))
    return stub


def _outcome_booker(book, rng):
    """Book a seeded outcome for each league 'g' task (the book's win
    rates move while the tasks are stamped)."""
    def on_task(task):
        if task.get('league_opponent'):
            book.record(task['league_opponent'],
                        float(rng.choice([0.0, 0.5, 1.0])))
        elif task.get('league_rating_match'):
            book.record(task['opponent'], float(rng.choice([0.0, 1.0])))
    return on_task


@pytest.mark.parametrize('env_name', ['TicTacToe', 'HungryGeese'])
def test_server_stamps_equal_the_jax_servers(tmp_path, env_name):
    """200 tasks: the port's ``_fresh_task`` and the JAX ``server()``
    loop give the same role_args (role, seats, model_id,
    league_opponent, league_seat, opponent, league_rating_match,
    sample_key) for the same seed, pool and book; a ledger re-issue
    replays them unchanged."""
    jpool, ppool = _pools(tmp_path, [1, 2, 3, 4], champion=3,
                          anchors=['random', 'rulebase'],
                          rating_match_rate=0.5)
    jbook, pbook = jax_league.RatingBook(), league.RatingBook()
    want = _jax_server_tasks(env_name, jpool, jbook, 200, 5,
                             _outcome_booker(jbook,
                                             np.random.default_rng(1)))
    stub = _port_task_stub(env_name, ppool, pbook, 5)
    book = _outcome_booker(pbook, np.random.default_rng(1))
    got = []
    for _ in range(200):
        task = stub._fresh_task()
        got.append(copy.deepcopy(task))
        book(task)
    assert got == want
    assert pbook.to_state() == jbook.to_state()
    roles = [t['role'] for t in got]
    assert 'e' in roles and 'g' in roles
    assert len({t['league_opponent'] for t in got
                if t.get('league_opponent')}) >= 3
    assert {t['opponent'] for t in got if t.get('league_rating_match')} \
        == set(ppool.roster())
    for t in got:
        if t.get('league_opponent'):
            # the learner (epoch 5) on its seat alone, the member on the rest
            mid = ppool.member_model_id(t['league_opponent'])
            assert t['model_id'] == {p: 5 if p == t['league_seat'] else mid
                                     for p in t['player']}
    # the ledger's booked args replay unchanged on a re-issue
    ledger = TaskLedger(deadline=300.0, clock=lambda: 0.0)
    for task in got:
        ledger.assign(('host', 1), copy.deepcopy(task))
    ledger.fail_endpoint(('host', 1))
    replayed = []
    while True:
        task = ledger.next_reissue()
        if task is None:
            break
        replayed.append(task)
    assert replayed == got


def test_league_off_leaves_tasks_as_they_were(tmp_path):
    """With the league off the stub stamps nothing the pre-league server
    did not: the JAX server's tasks without a pool."""
    want = _jax_server_tasks('TicTacToe', None, None, 50, 3, lambda t: None)
    stub = _port_task_stub('TicTacToe', None, None, 3)
    got = [stub._fresh_task() for _ in range(50)]
    assert got == want
    assert not any(k.startswith('league') or k == 'opponent'
                   for t in got for k in t)


# ------------------------------------------------------- the worker side

def _ttt_snapshot(seed):
    env = make_env({'env': 'TicTacToe'})
    net = env.net()
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net, params_bytes(net, {k: v.detach() for k, v in
                                   net.state_dict().items()})


def _learner_stub(model_dir, pool):
    """The parts of a port Learner the 'model' reply and the GC read."""
    net, _ = _ttt_snapshot(0)
    stub = type('LearnerStub', (), {})()
    stub.args = {'keep_checkpoints': 2, 'eval': {}, 'serving': {}}
    stub.model_dir = str(model_dir)
    stub.model_epoch = 9
    stub.module = net
    stub.params = {k: v.detach() for k, v in net.state_dict().items()}
    stub._snapshot_cache = None
    stub._registry = None
    stub._league = pool
    for name in ('model_path', '_registry_root', '_ensure_registry',
                 '_model_snapshot', '_league_model_snapshot',
                 '_gc_checkpoints'):
        setattr(stub, name, getattr(Learner, name).__get__(stub))
    return stub


def test_model_reply_falls_back_to_the_registry(tmp_path):
    """A member's numbered checkpoint gone from model_dir: the 'model'
    reply is its registry version (CRC-verified), not the live params."""
    model_dir, root = tmp_path / 'models', tmp_path / 'registry'
    os.makedirs(str(model_dir))
    reg = ModelRegistry(str(root))
    net3, raw3 = _ttt_snapshot(3)
    reg.publish(LINE, snapshot={'architecture': 'SimpleConv2dModel',
                                'params': raw3}, version=3, promote=True)
    pool = league.LeaguePool(_league_args(), LINE)
    pool.refresh(reg)
    stub = _learner_stub(model_dir, pool)
    stub.args['serving'] = {'registry_dir': str(root)}
    snap = stub._model_snapshot(3)
    assert snap['params'] == raw3
    assert snap['architecture'] == 'SimpleConv2dModel'
    live = params_bytes(stub.module, stub.params)
    assert live != raw3
    # an id the registry does not know: the live params, as before
    assert stub._model_snapshot(4)['params'] == live
    # the league off: the live params
    stub._league = None
    assert stub._model_snapshot(3)['params'] == live
    # a numbered checkpoint present wins
    stub._league = pool
    checksummed_write_bytes(str(model_dir / '3.ckpt'), b'numbered')
    assert stub._model_snapshot(3)['params'] == b'numbered'
    # the snapshot loads in a worker's vault
    w = ModelWrapper.from_snapshot(reg.load_snapshot(LINE, '3'),
                                   device='cpu')
    assert isinstance(w, ModelWrapper)


def test_gc_pins_league_member_checkpoints(tmp_path):
    model_dir = tmp_path / 'models'
    os.makedirs(str(model_dir))
    for e in (1, 2, 3, 4, 5):
        checksummed_write_bytes(str(model_dir / ('%d.ckpt' % e)),
                                b'ckpt-%d' % e)
    pool = league.LeaguePool({}, LINE)
    pool._member_paths = {'default@1': str(model_dir / '1.ckpt')}
    stub = _learner_stub(model_dir, pool)

    def left():
        return sorted(int(n.split('.')[0]) for n in os.listdir(model_dir)
                      if n.endswith('.ckpt'))
    stub._gc_checkpoints()
    assert left() == [1, 4, 5]
    pool._member_paths = {}
    stub._gc_checkpoints()
    assert left() == [4, 5]


@pytest.mark.parametrize('env_name,opponent', [
    ('TicTacToe', 'random'), ('ConnectX', 'rulebase'),
    ('TicTacToe', 'default@3')])
def test_evaluator_plays_the_stamped_opponent(env_name, opponent):
    """A rating match's stamp wins over the configured pool: an anchor by
    name, a member as the model riding its model_id seat."""
    env = make_env({'env': env_name})
    env.reset()
    net = env.net()
    net.reset_parameters(torch.Generator().manual_seed(1))
    model = ModelWrapper(net, 'cpu')
    ev = Evaluator(env, {'eval': {'opponent': ['rulebase-9']}, 'seed': 0},
                   device='cpu')
    played = []
    real = ev._opponent_agent

    def spy(spec):
        played.append(spec)
        return real(spec)
    ev._opponent_agent = spy
    member = opponent.startswith('default@')
    task = {'role': 'e', 'player': [1], 'opponent': opponent,
            'league_rating_match': True, 'sample_key': 4}
    models = {0: model if member else None, 1: model}
    rec = ev.execute(models, task)
    assert rec['opponent'] == opponent
    assert abs(sum(rec['result'].values())) < 1e-9
    assert played == ([] if member else [opponent])
    # without the stamp the pool's draw applies
    rec = ev.execute({0: None, 1: model}, {'role': 'e', 'player': [1],
                                           'sample_key': 4})
    assert rec['opponent'] == 'rulebase-9'


def test_model_vault_serves_id_zero_as_the_random_model():
    from handyrl_tpu_torch.inference import RandomModel
    env = make_env({'env': 'TicTacToe'})
    env.reset()
    _, raw = _ttt_snapshot(2)
    snap = {'architecture': 'SimpleConv2dModel', 'params': raw}
    vault = ModelVault(lambda mid: snap, env.observation(0), device='cpu')
    got = vault.obtain({0: 0, 1: 3})
    assert isinstance(got[0], RandomModel)
    assert isinstance(got[1], ModelWrapper)
    assert vault.obtain({0: -1})[0] is None


def _classifiers(env_name):
    """(JAX engine, port engine) on one config; _classify reads no
    weights, so the vaults fetch nothing."""
    raw = {'env_args': {'env': env_name}, 'train_args': {'seed': 11}}
    tas = []
    for apply in (jax_apply_defaults, apply_defaults):
        cfg = apply(copy.deepcopy(raw))
        ta = dict(cfg['train_args'])
        ta['env'] = cfg['env_args']
        tas.append(ta)
    jta, pta = tas

    def nofetch(mid):
        raise AssertionError('no weights are read')
    jenv = jax_make_env(jta['env'])
    jenv.reset()
    jeng = jdg.DeviceActorEngine(
        make_jax_env(jta['env']),
        JaxModelVault(nofetch, jenv.observation(jenv.players()[0])),
        jax_make_env(jta['env']), jta, n_envs=4, chunk_steps=4, slots=2,
        seed=5)
    penv = make_env(pta['env'])
    penv.reset()
    peng = dg.DeviceActorEngine(
        make_device_env(pta['env']),
        ModelVault(nofetch, penv.observation(penv.players()[0]),
                   device='cpu'),
        make_env(pta['env']), pta, n_envs=4, chunk_steps=4, slots=2,
        seed=5, device='cpu')
    return jeng, peng


@pytest.mark.parametrize('env_name', ['TicTacToe', 'HungryGeese'])
def test_device_actor_classifies_stamped_tasks_as_the_jax_engine(tmp_path,
                                                                  env_name):
    """League 'g' tasks (a member's slot beside the learner's, the random
    anchor uniform) and rating matches (a member greedy in a slot, the
    anchors by name) take the JAX engine's modes and slot ids."""
    _, ppool = _pools(tmp_path, [1, 2, 3], anchors=['random', 'rulebase'],
                      self_play_rate=0.3, rating_match_rate=1.0)
    stub = _port_task_stub(env_name, ppool, league.RatingBook(), 4)
    stub.eval_rate = 0.5
    tasks = [stub._fresh_task() for _ in range(60)]
    assert any(t.get('league_opponent') for t in tasks)
    assert any(t.get('league_rating_match') for t in tasks)
    jeng, peng = _classifiers(env_name)
    kinds = set()
    for task in tasks:
        task = dict(task, task_id=0)
        want, got = jeng._classify(task), peng._classify(task)
        assert (got is None) == (want is None), task
        if got is None:
            continue
        for key in ('kind', 'modes', 'mids', 'slot_mids', 'opponent'):
            assert got[key] == want[key], (key, task)
        kinds.add((got['kind'], task.get('league_opponent')
                   or task.get('opponent')))
    assert {k for k, _ in kinds} == {'episode', 'result'}


# ------------------------------------------------------------------- F6

def test_serve_reads_the_learners_registry_as_the_jax_service(tmp_path,
                                                              monkeypatch):
    """``--serve --config`` with ``train_args.model_dir`` and no
    ``registry_dir``: the service's root is that model_dir, as the JAX
    service resolves it (handyrl_tpu/serving/service.py:111); an explicit
    ``registry_dir`` wins; with neither, 'models'."""
    from handyrl_tpu.serving.service import InferenceService as JaxService
    seen = []
    monkeypatch.setattr(service, 'serve_main',
                        lambda args, device: seen.append(args) or 0)
    model_dir = str(tmp_path / 'learner_models')
    cases = [({'model_dir': model_dir, 'serving': {'port': 0}}, model_dir),
             ({'model_dir': model_dir,
               'serving': {'port': 0, 'registry_dir': str(tmp_path / 'r')}},
              str(tmp_path / 'r')),
             ({'serving': {'port': 0}}, 'models')]
    for train_args, root in cases:
        cfg = tmp_path / 'cfg.json'
        cfg.write_text(json.dumps({'env_args': {'env': 'TicTacToe'},
                                   'train_args': train_args}))
        assert cli.main(['--serve', '--config', str(cfg), '--device',
                         'cpu']) == 0
        args = seen[-1]
        assert args['serving']['registry_dir'] == root
        # the JAX service on the same train_args
        jax_args = dict(copy.deepcopy(train_args), env={'env': 'TicTacToe'})
        jsvc = JaxService(jax_args)
        assert os.path.abspath(jsvc.registry.root) == os.path.abspath(root)
        psvc = service.InferenceService(args, device='cpu')
        assert os.path.abspath(psvc.registry.root) == os.path.abspath(root)
