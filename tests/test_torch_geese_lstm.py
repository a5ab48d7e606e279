"""The recurrent path of the port: ``ConvLSTMCell`` and ``DRC``
(handyrl_tpu_torch/models/blocks.py), ``GeeseNetLSTM`` (models/geese.py),
the recurrent loss with burn-in (ops/losses.py, ops/train_step.py), the
hidden state through the host generators and the serving engine, and the
host learner training a GeeseNetLSTM, against the JAX package's
(handyrl_tpu/models/blocks.py, models/geese.py, ops/losses.py,
generation.py, inference.py; tests/test_geese_lstm.py,
tests/test_losses.py).

Params are carried from flax inits (perturbed so no norm is the identity)
with ``params_from_flax``; inputs come from numpy with a seed.

Tolerances:
- the blocks and the net over 6 steps of carried state, outputs and
  ``(h, c)``: 1e-5 absolute (fp32 convs and GroupNorm statistics summed
  in other orders; up to 7e-6 seen at full width after 6 steps);
- the loss with burn-in: each term within 1e-5 relative (atol 1e-4, sums
  over B*T*P terms of order 1), the grads within 1e-4 of each grad's
  largest element (sums over B*T*P*77 pixels through T steps in other
  orders);
- the generators: actions, observations, masks and outcomes exact, values
  and probabilities within 1e-5 (the same Gumbel draws on the same logits
  within rounding);
- the served policy and hidden within 1e-5 of the JAX service's;
- the param round trip and snapshot bytes exact."""

import copy
import json
import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.generation import BatchedEvaluator as JaxBatchedEvaluator
from handyrl_tpu.generation import BatchedGenerator as JaxBatchedGenerator
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models import blocks as jblocks
from handyrl_tpu.models.geese import GeeseNetLSTM as JaxLSTM
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.losses import compute_loss as jax_compute_loss
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.generation import BatchedEvaluator, BatchedGenerator
from handyrl_tpu_torch.inference import InferenceEngine
from handyrl_tpu_torch.model import ModelWrapper, params_bytes
from handyrl_tpu_torch.models import blocks
from handyrl_tpu_torch.models.geese import (GeeseNetLSTM, params_from_flax,
                                            params_to_flax)
from handyrl_tpu_torch.ops import batch as tbatch
from handyrl_tpu_torch.ops import losses
from handyrl_tpu_torch.ops.train_step import (build_update_step,
                                              init_hidden_for,
                                              init_train_state)


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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_ATOL_OF_MAX = 1e-4
GEESE = {'env': 'HungryGeese', 'net_kind': 'lstm'}


def _perturb(tree, seed):
    rng = np.random.RandomState(seed)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        a = np.asarray(t)
        return a + 0.1 * rng.randn(*a.shape).astype(np.float32)
    return go(tree)


def _nhwc(t):
    return np.asarray(t).transpose(0, 2, 3, 1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _geese_obs(rng, shape=(5,)):
    obs = (rng.rand(*shape, 17, 7, 11) < 0.15).astype(np.float32)
    return obs


# -- the blocks --------------------------------------------------------------

def _cell_params(tree, prefix=''):
    """torch state dict entries of a flax ConvLSTMCell's ``Conv_0``."""
    conv = tree['Conv_0']
    return {prefix + 'conv.weight': torch.from_numpy(np.ascontiguousarray(
                np.asarray(conv['kernel']).transpose(3, 2, 0, 1))),
            prefix + 'conv.bias': torch.from_numpy(np.asarray(conv['bias']))}


@pytest.mark.timeout(60)
def test_convlstm_cell_matches_flax_over_six_steps():
    rng = np.random.RandomState(0)
    C, F, N = 5, 8, 4
    cell = jblocks.ConvLSTMCell(F)
    x0 = rng.randn(N, 7, 11, C).astype(np.float32)
    zeros = np.zeros((N, 7, 11, F), np.float32)
    params = _perturb(cell.init(jax.random.PRNGKey(0), x0, (zeros, zeros)),
                      1)
    mine = blocks.ConvLSTMCell(C, F)
    mine.load_state_dict(_cell_params(params['params']))
    js, ts = (zeros, zeros), (_nchw(zeros), _nchw(zeros))
    for _ in range(6):
        x = rng.randn(N, 7, 11, C).astype(np.float32)
        jh, js = cell.apply(params, x, js)
        th, ts = mine(_nchw(x), ts)
        np.testing.assert_allclose(_nhwc(th.detach()), np.asarray(jh),
                                   rtol=0, atol=TOL)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(_nhwc(a.detach()), np.asarray(b),
                                       rtol=0, atol=TOL)


@pytest.mark.timeout(60)
def test_drc_matches_flax_over_six_steps():
    rng = np.random.RandomState(2)
    C, F, N = 6, 8, 3
    drc = jblocks.DRC(num_layers=2, features=F, num_repeats=2)
    x0 = rng.randn(N, 7, 11, C).astype(np.float32)
    params = _perturb(drc.init(jax.random.PRNGKey(1), x0, None), 3)
    mine = blocks.DRC(C, num_layers=2, features=F, num_repeats=2)
    state = {}
    for i in range(2):
        state.update(_cell_params(params['params']['ConvLSTMCell_%d' % i],
                                  'cells.%d.' % i))
    mine.load_state_dict(state)
    js, ts = None, None
    for _ in range(6):
        x = rng.randn(N, 7, 11, C).astype(np.float32)
        jh, js = drc.apply(params, x, js)
        th, ts = mine(_nchw(x), ts)
        np.testing.assert_allclose(_nhwc(th.detach()), np.asarray(jh),
                                   rtol=0, atol=TOL)
        for got, want in zip(ts, js):
            for a, b in zip(got, want):
                np.testing.assert_allclose(_nhwc(a.detach()), np.asarray(b),
                                           rtol=0, atol=TOL)


def _lstm_pair(filters, stem_layers, seed=0):
    jm = JaxLSTM(filters=filters, stem_layers=stem_layers)
    obs = _geese_obs(np.random.RandomState(seed))
    params = _perturb(jm.init(jax.random.PRNGKey(seed), obs, None), seed + 1)
    net = GeeseNetLSTM(filters=filters, stem_layers=stem_layers)
    net.load_state_dict(params_from_flax(params))
    return jm, params, net


@pytest.mark.timeout(120)
@pytest.mark.parametrize('filters,stem_layers', [(8, 1), (32, 4)])
def test_geesenet_lstm_matches_flax_over_six_steps(filters, stem_layers):
    jm, params, net = _lstm_pair(filters, stem_layers)
    rng = np.random.RandomState(7)
    jh = th = None
    for step in range(6):
        # one leading axis, as every caller of the JAX net folds its rows
        # (flax's GroupNorm takes the first axis alone as the batch)
        obs = _geese_obs(rng, (6,))
        jo = jm.apply(params, obs, jh)
        to = net(torch.from_numpy(obs), th)
        jh, th = jo['hidden'], to['hidden']
        for k in ('policy', 'value'):
            assert to[k].shape == jo[k].shape
            np.testing.assert_allclose(to[k].detach().numpy(),
                                       np.asarray(jo[k]), rtol=0, atol=TOL,
                                       err_msg='%s step %d' % (k, step))
        assert len(th) == 2
        for a, b in zip(th, jh):
            assert tuple(a.shape) == (6, 7, 11, filters)
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=0, atol=TOL)
    # a (B, P) lead is the folded rows' function, the state shaped alike
    folded = net(torch.from_numpy(obs), th)
    lead = net(torch.from_numpy(obs.reshape((2, 3) + obs.shape[1:])),
               tuple(t.reshape((2, 3) + t.shape[1:]) for t in th))
    torch.testing.assert_close(lead['policy'].reshape(6, 4),
                               folded['policy'])
    assert tuple(lead['hidden'][1].shape) == (2, 3, 7, 11, filters)
    torch.testing.assert_close(lead['hidden'][1].reshape(folded['hidden'][1]
                                                         .shape),
                               folded['hidden'][1])
    for a, b in zip(net.init_hidden((2, 3)), jm.init_hidden((2, 3))):
        assert tuple(a.shape) == b.shape and not a.any()


@pytest.mark.timeout(60)
def test_params_and_snapshots_cross_both_packages():
    jm, params, net = _lstm_pair(8, 1, seed=3)
    back = params_to_flax(net)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        assert np.array_equal(a, b)
    # the JAX wrapper's snapshot (a flax init's tree, in creation order)
    # loads in the port and is written back byte for byte
    obs = _geese_obs(np.random.RandomState(4), ())
    jw = JaxModelWrapper(JaxLSTM(filters=8, stem_layers=1), seed=5)
    jw.ensure_params(obs)
    pw = ModelWrapper.from_snapshot(jw.snapshot(), device='cpu')
    assert isinstance(pw.module, GeeseNetLSTM)
    assert pw.module.config() == {'filters': 8, 'stem_layers': 1}
    assert params_bytes(pw.module) == jw.params_bytes()
    # the single-sample host surface: numpy state, carried
    h0, jh0 = pw.init_hidden(), jw.init_hidden()
    assert [a.shape for a in h0] == [a.shape for a in jh0]
    got, want = pw.inference(obs, h0), jw.inference(obs, jh0)
    for a, b in zip(got['hidden'], want['hidden']):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    np.testing.assert_allclose(got['policy'], want['policy'], rtol=0,
                               atol=TOL)
    assert isinstance(make_env(GEESE).net(), GeeseNetLSTM)
    with pytest.raises(ValueError, match='pad'):
        GeeseNetLSTM(torus_impl='pallas')


# -- the loss ------------------------------------------------------------------

def _recurrent_batch(B, T, P, rng, turn_based):
    """A (B, T, P) window of Geese observations: in the solo layout every
    goose observes where its random mask says so; in the turn layout two
    players alternate, only the turn player observing. Some episodes end
    inside the window; some actions are illegal (never the one taken)."""
    if turn_based:
        mask = np.zeros((B, T, P, 1), np.float32)
        first = rng.randint(0, 2, B)
        for b in range(B):
            for t in range(T):
                mask[b, t, (first[b] + t) % 2] = 1
    else:
        mask = (rng.rand(B, T, P, 1) < 0.8).astype(np.float32)
    # the turn layout keeps the acting player's row alone (make_batch)
    P_obs = 1 if turn_based else P
    emask = np.ones((B, T, P_obs, 1), np.float32)
    for b in range(0, B, 2):
        emask[b, T - 1 - b % T:] = 0
    action = rng.randint(0, 4, (B, T, P_obs, 1)).astype(np.int32)
    amask = np.where(rng.rand(B, T, P_obs, 4) < 0.3, 1e32,
                     0).astype(np.float32)
    np.put_along_axis(amask, action, 0, axis=-1)
    return {
        'observation': _geese_obs(rng, (B, T, P_obs)),
        'selected_prob': rng.uniform(0.1, 1.0, (B, T, P_obs, 1)).astype(
            np.float32),
        'value': rng.uniform(-1, 1, (B, T, P, 1)).astype(np.float32),
        'action': action,
        'outcome': np.sign(rng.randn(B, 1, P, 1)).astype(np.float32),
        'reward': (0.1 * rng.randn(B, T, P, 1)).astype(np.float32),
        'return': rng.uniform(-1, 1, (B, T, P, 1)).astype(np.float32),
        'episode_mask': emask,
        'turn_mask': mask,
        'observation_mask': mask.copy(),
        'action_mask': amask,
        'progress': np.linspace(0, 1, T, dtype=np.float32)[None, :, None]
        .repeat(B, 0),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.timeout(180)
@pytest.mark.parametrize('pt,vt,turn_based', [('VTRACE', 'VTRACE', False),
                                              ('TD', 'TD', True)])
def test_burn_in_loss_terms_and_grads_match_jax(pt, vt, turn_based):
    """``burn_in_steps`` 2, ``forward_steps`` 6: the burn-in pass without
    gradients, then 6 steps carrying the gated state."""
    bi, fs, B = 2, 6, 3
    P = 2 if turn_based else 4
    rng = np.random.RandomState(11)
    batch = _recurrent_batch(B, bi + fs, P, rng, turn_based)
    jm, params, net = _lstm_pair(8, 1, seed=5)
    kw = dict(turn_based_training=turn_based, observation=not turn_based,
              burn_in_steps=bi, policy_target=pt, value_target=vt,
              gamma=0.99)
    jcfg, cfg = JaxLossConfig(**kw), losses.LossConfig(**kw)
    jhidden = jm.init_hidden((B, P))

    def jloss(p):
        return jax_compute_loss(jm.apply, p, jhidden, batch, jcfg)
    (_, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    live = {k: v.detach().requires_grad_(True)
            for k, v in net.named_parameters()}

    def apply_fn(p, obs, hidden):
        return torch.func.functional_call(net, p, (obs, hidden))
    tb = _torch_batch(batch)
    hidden = init_hidden_for(net, tb)
    assert [tuple(h.shape) for h in hidden] == [(B, P, 7, 11, 8)] * 2
    total, aux = losses.compute_loss(apply_fn, live, hidden, tb, cfg)
    grads = dict(zip(live, torch.autograd.grad(total, list(live.values()))))
    for k, v in aux['losses'].items():
        np.testing.assert_allclose(v.item(), float(jaux['losses'][k]),
                                   err_msg=k, **LOSS_TOL)
    assert aux['data_count'].item() == float(jaux['data_count'])
    for k, v in aux['diag'].items():
        np.testing.assert_allclose(v.item(), float(jaux['diag'][k]),
                                   err_msg=k, **LOSS_TOL)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, err_msg=k, rtol=0,
                                   atol=GRAD_ATOL_OF_MAX * np.abs(w).max())


@pytest.mark.timeout(120)
def test_burn_in_matches_t_slicing():
    """The port's counterpart of tests/test_losses.py's
    ``test_rnn_burn_in_matches_T_slicing``: the forward covers the whole
    window with the burn-in rows zero, the loss covers the main window
    only, and the state the burn-in leaves carries no gradient (the loss
    equals the loss on the main window from that state, and so do its
    grads)."""
    bi, fs, B, P = 2, 3, 2, 4
    rng = np.random.RandomState(13)
    batch = _torch_batch(_recurrent_batch(B, bi + fs, P, rng, False))
    _, _, net = _lstm_pair(8, 1, seed=6)
    cfg = losses.LossConfig(turn_based_training=False, observation=True,
                            burn_in_steps=bi, policy_target='VTRACE',
                            value_target='VTRACE', gamma=0.99)
    live = {k: v.detach().requires_grad_(True)
            for k, v in net.named_parameters()}

    def apply_fn(p, obs, hidden):
        return torch.func.functional_call(net, p, (obs, hidden))
    h0 = init_hidden_for(net, batch)
    out = losses.forward_prediction(apply_fn, live, h0, batch, cfg)
    assert out['policy'].shape[1] == bi + fs
    assert not out['value'][:, :bi].any()
    total, _ = losses.compute_loss(apply_fn, live, h0, batch, cfg)
    # the state after burn-in, then the main window alone
    with torch.no_grad():
        h = h0
        for t in range(bi):
            m = batch['observation_mask'][:, t].reshape(B, P, 1, 1, 1)
            o = net(batch['observation'][:, t], tuple(x * m for x in h))
            h = tuple(x * (1 - m) + n * m for x, n in zip(h, o['hidden']))
    main = losses._slice_burn_in(batch, bi)
    total2, _ = losses.compute_loss(apply_fn, live, h, main,
                                    cfg._replace(burn_in_steps=0))
    torch.testing.assert_close(total, total2, rtol=1e-6, atol=1e-6)
    g1 = torch.autograd.grad(total, list(live.values()))
    g2 = torch.autograd.grad(total2, list(live.values()))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.timeout(120)
def test_update_step_takes_the_recurrent_state():
    """``build_update_step`` starts each window from ``init_hidden_for``:
    one step on a recurrent batch is finite and moves every parameter
    leaf."""
    _, _, net = _lstm_pair(8, 1, seed=8)
    rng = np.random.RandomState(14)
    batch = _torch_batch(_recurrent_batch(2, 6, 4, rng, False))
    cfg = losses.LossConfig(turn_based_training=False, observation=True,
                            burn_in_steps=2, policy_target='VTRACE',
                            value_target='VTRACE', gamma=0.99)
    state = init_train_state(net)
    new, metrics = build_update_step(net, cfg)(state, batch,
                                               torch.tensor(1e-3))
    assert metrics['nonfinite'].item() == 0
    for k, v in state.params.items():
        assert not torch.equal(v, new.params[k]), k
    assert init_hidden_for(make_env({'env': 'HungryGeese'}).net(),
                           batch) is None


# -- the hidden state through the host generators and serving ------------------

ENVS = 4


def _wrappers():
    jw = JaxModelWrapper(JaxLSTM(filters=8, stem_layers=1), seed=3)
    jw.ensure_params(jax_make_env(GEESE).observation(0))
    net = GeeseNetLSTM(filters=8, stem_layers=1)
    net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jw.params)))
    return jw, ModelWrapper(net, device='cpu')


def _run(gen_cls, make, wrapper, args, until, seed):
    np.random.seed(seed)
    random.seed(seed)
    gen = gen_cls(lambda i: make(dict(GEESE, id=i)), wrapper, args,
                  n_envs=ENVS)
    out, plies = [], 0
    while len(out) < until:
        out += gen.step()
        plies += 1
        assert plies < 2000
    return out, gen


@pytest.mark.timeout(180)
def test_batched_generator_carries_the_hidden_state_like_the_reference():
    jw, pw = _wrappers()
    args = {'observation': True, 'gamma': 0.99, 'compress_steps': 4}
    want, jgen = _run(JaxBatchedGenerator, jax_make_env, jw, args, 6, 5)
    got, pgen = _run(BatchedGenerator, make_env, pw, args, 6, 5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g['steps'] == w['steps'] and g['outcome'] == w['outcome']
        for a, b in zip(tbatch.decompress_moments(g['moment']),
                        tbatch.decompress_moments(w['moment'])):
            assert a['turn'] == b['turn'] and a['action'] == b['action']
            for p in b['value']:
                if b['value'][p] is not None:
                    np.testing.assert_allclose(a['value'][p], b['value'][p],
                                               rtol=0, atol=TOL)
    # the slots' states: numpy, one per (env, player), as the reference's
    for mine, ref in zip(pgen._hidden, jgen._hidden):
        assert mine.keys() == ref.keys()
        for p in ref:
            for a, b in zip(mine[p], ref[p]):
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


@pytest.mark.timeout(180)
def test_batched_evaluator_carries_each_seats_state(tmp_path):
    """Random and a recurrent checkpoint opponent, whose seats keep their
    own state: the same results as the reference's."""
    jw, pw = _wrappers()
    path = str(tmp_path / '2.ckpt')
    opp = GeeseNetLSTM(generator=torch.Generator().manual_seed(2))
    with open(path, 'wb') as f:
        f.write(params_bytes(opp))
    args = {'eval': {'opponent': ['random', path]}}
    want, _ = _run(JaxBatchedEvaluator, jax_make_env, jw, args, 6, 9)
    got, gen = _run(BatchedEvaluator, make_env, pw, args, 6, 9)
    assert got == want
    states = [s for st in gen._slot_state for s in st['model_seats'].values()]
    assert all(len(s['hidden']) == 2 for s in states)


@pytest.mark.timeout(120)
def test_engine_answers_with_the_next_hidden_state():
    """A None hidden is the net's zero state on the engine's side, and each
    reply carries its row's next state: the same numbers as the JAX
    wrapper's single-sample inference, carried over three plies."""
    import queue
    jw, pw = _wrappers()
    env = make_env(GEESE)
    env.reset()
    replies = queue.Queue()
    engine = InferenceEngine({'inference': {'batch_wait_ms': 1.0}},
                             lambda mid: pw.snapshot(),
                             lambda ep, msg: replies.put(msg),
                             env.observation(0), device='cpu')
    engine.start()
    try:
        rng = np.random.RandomState(3)
        hidden, jhidden = None, jw.init_hidden()
        for ply in range(3):
            obs = _geese_obs(rng, ())
            engine.submit('ep', {'rid': ply, 'mid': 1, 'obs': obs,
                                 'hidden': hidden})
            reply = replies.get(timeout=60)
            assert reply['rid'] == ply, reply
            out = reply['outputs']
            want = jw.inference(obs, jhidden)
            np.testing.assert_allclose(out['policy'], want['policy'],
                                       rtol=0, atol=TOL)
            assert len(out['hidden']) == 2
            for a, b in zip(out['hidden'], want['hidden']):
                assert a.shape == (7, 11, 8)
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
            hidden, jhidden = out['hidden'], want['hidden']
    finally:
        engine.stop()


# -- the host learner ------------------------------------------------------------

@pytest.mark.timeout(300)
def test_host_learner_trains_a_geesenet_lstm(tmp_path):
    """The port's counterpart of tests/test_geese_lstm.py's
    ``test_trains_through_rnn_path``: one epoch of the host learner with
    ``net_kind: 'lstm'``, burn-in 2, VTRACE/VTRACE, through the CLI."""
    cfg = {'env_args': dict(GEESE),
           'train_args': {'turn_based_training': False, 'observation': True,
                          'gamma': 0.99, 'forward_steps': 6,
                          'burn_in_steps': 2, 'batch_size': 4,
                          'update_episodes': 4, 'minimum_episodes': 4,
                          'epochs': 1, 'generation_envs': 4,
                          'num_batchers': 1, 'policy_target': 'VTRACE',
                          'value_target': 'VTRACE',
                          'model_dir': str(tmp_path / 'models')}}
    assert apply_defaults(copy.deepcopy(cfg))['train_args'][
        'burn_in_steps'] == 2
    path = tmp_path / 'cfg.json'
    path.write_text(json.dumps(cfg))
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
         str(path), '--device', 'cpu'], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS='1'), capture_output=True,
        text=True, timeout=280)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads([l for l in proc.stdout.splitlines()
                       if l.startswith('{')][-1])
    assert line['model_epoch'] == 1 and line['steps'] > 0
    assert not line['failed']
    for k in ('p', 'v', 'total'):
        assert np.isfinite(line['losses'][k])
    ckpt = (tmp_path / 'models' / '1.ckpt').read_bytes()
    # the checkpoint is a GeeseNetLSTM the JAX package loads
    from handyrl_tpu.evaluation import load_model as jax_load_model
    jmodel = jax_load_model(str(tmp_path / 'models' / '1.ckpt'),
                            jax_make_env(GEESE))
    assert type(jmodel.module).__name__ == 'GeeseNetLSTM'
    assert len(ckpt) > 0
