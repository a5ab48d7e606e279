"""The port's exported program (``.pt2``: handyrl_tpu_torch/export.py,
scripts/torch_export_model.py) and ``evaluation.ExportedModel`` on the
CPU, against the JAX package's export (scripts/export_model.py, default
mode) and its ``ExportedModel`` (handyrl_tpu/evaluation.py:467-514).

One checkpoint a game, written from seeded weights and read by both
packages: TicTacToe's SimpleConv2dModel and the full-width Hungry Geese
GeeseNet (filters 32, 12 blocks). Each package exports it with its own
script. The JAX script builds the env's net with its default trunk
(``torus_impl='pad'``: the Pallas kernel does not export under
``jax.export`` on the CPU, and 'pad' is the same function of the same
params), the port's the kernel trunk, so the ``.pt2`` graph holds K1 as
``handyrl_tpu_torch::geese_trunk``. The port's ``ExportedModel`` (the
plain trunk inside the operator on the CPU) is held to the JAX
``ExportedModel`` on real observations within 1e-4 abs: fp32, the same
math, sums in other orders. The file also loads in a fresh process that
imports no ``handyrl_tpu`` and no ``handyrl_tpu_torch.models``, and gives
the same outputs there exactly (the same program on the same CPU).
``load_model`` returns an ``ExportedModel`` for ``.pt2``, refuses
``.jaxexp`` naming ``.pt2`` and the export script, and without a card
the default device raises naming CUDA.

The recurrent GeeseNetLSTM (filters 32, 4 stem layers) is exported with
``--net-kind lstm``: its program takes and returns the hidden state. The
JAX script builds only the env's default net, so its export of the same
checkpoint is made here as the script makes it for a recurrent net
(``scripts/export_model.py:77-92``: the hidden state's batch-1 spec an
input). The two ``ExportedModel``s are held to each other over plies of
carried hidden state within 1e-4 abs, the hidden state too.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from handyrl_tpu.evaluation import ExportedModel as JaxExportedModel
from handyrl_tpu_torch import evaluation
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.export import OP_NAME, program_ops
from handyrl_tpu_torch.model import params_bytes

pytestmark = pytest.mark.timeout(240)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, 'scripts', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _observations(env_name, n=6, seed=3):
    env = make_env({'env': env_name})
    rng = np.random.RandomState(seed)
    env.reset()
    obs = []
    while len(obs) < n:
        if env.terminal():
            env.reset()
        for p in env.turns():
            obs.append(np.asarray(env.observation(p), np.float32))
        env.step({p: int(rng.choice(env.legal_actions(p)))
                  for p in env.turns()})
    return obs[:n]


@pytest.fixture(scope='module', params=['TicTacToe', 'HungryGeese'])
def exported(request, tmp_path_factory):
    """(env name, checkpoint, the port's .pt2, the JAX .jaxexp)."""
    name = request.param
    tmp = tmp_path_factory.mktemp(name)
    net = make_env({'env': name}).net()
    net.reset_parameters(torch.Generator().manual_seed(5))
    ckpt = str(tmp / 'm.ckpt')
    with open(ckpt, 'wb') as f:
        f.write(params_bytes(net, dict(net.named_parameters())))
    pt2, jaxexp = str(tmp / 'm.pt2'), str(tmp / 'm.jaxexp')
    assert _script('torch_export_model').main([name, ckpt, pt2]) == 0
    argv = sys.argv
    sys.argv = ['export_model.py', name, ckpt, jaxexp]
    try:
        _script('export_model').main()
    finally:
        sys.argv = argv
    return name, ckpt, pt2, jaxexp


def test_exported_model_matches_the_jax_export(exported):
    name, _, pt2, jaxexp = exported
    model = evaluation.load_model(pt2, make_env({'env': name}),
                                  device='cpu')
    assert isinstance(model, evaluation.ExportedModel)
    assert model.init_hidden() is None
    jm = JaxExportedModel(jaxexp)
    for obs in _observations(name):
        got, want = model.inference(obs), jm.inference(obs)
        assert sorted(got) == sorted(want) == ['policy', 'value']
        for k in got:
            assert got[k].shape == np.asarray(want[k]).shape, k
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                       atol=TOL, err_msg=k)


def test_the_kernel_is_one_node_of_the_geese_program(exported):
    name, _, pt2, _ = exported
    ops = program_ops(torch.export.load(pt2))
    trunk = [o for o in ops if 'geese_trunk' in o]
    if name == 'HungryGeese':
        assert trunk == [OP_NAME.replace('::', '.') + '.default']
    else:
        assert trunk == []


def test_loads_without_the_net_classes_in_a_fresh_process(exported,
                                                          tmp_path):
    name, _, pt2, _ = exported
    obs = _observations(name, n=1)[0]
    np.save(tmp_path / 'obs.npy', obs)
    code = (
        'import json, sys\n'
        'import numpy as np\n'
        'from handyrl_tpu_torch.evaluation import ExportedModel\n'
        'm = ExportedModel(sys.argv[1], device="cpu")\n'
        'out = m.inference(np.load(sys.argv[2]))\n'
        'bad = sorted(k for k in sys.modules if k == "handyrl_tpu"\n'
        '             or k.startswith("handyrl_tpu.")\n'
        '             or k.startswith("handyrl_tpu_torch.models"))\n'
        'print(json.dumps({"out": {k: v.tolist() for k, v in out.items()},\n'
        '                  "bad": bad, "hidden": m.init_hidden()}))\n')
    proc = subprocess.run(
        [sys.executable, '-c', code, pt2, str(tmp_path / 'obs.npy')],
        cwd=REPO, capture_output=True, text=True, timeout=200,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line['bad'] == [] and line['hidden'] is None
    want = evaluation.ExportedModel(pt2, device='cpu').inference(obs)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(line['out'][k], np.float32),
                                      v, err_msg=k)


def test_jaxexp_is_refused_and_the_card_is_the_default(exported):
    name, _, pt2, jaxexp = exported
    env = make_env({'env': name})
    with pytest.raises(ValueError) as exc:
        evaluation.load_model(jaxexp, env, device='cpu')
    for word in ('.jaxexp', 'ExportedModel', '.pt2',
                 'scripts/torch_export_model.py'):
        assert word in str(exc.value)
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device loads there')
    with pytest.raises(RuntimeError, match='CUDA'):
        evaluation.load_model(pt2, env).inference(_observations(name, 1)[0])


def _jax_export_recurrent(ckpt, out_path):
    """The JAX package's export of a recurrent checkpoint, as
    ``scripts/export_model.py`` makes it for a net with a hidden state."""
    import jax
    import jax.numpy as jnp
    from jax import export as jexport
    from handyrl_tpu.environment import make_env as jax_make_env
    from handyrl_tpu.evaluation import load_model as jax_load_model
    env = jax_make_env({'env': 'HungryGeese', 'net_kind': 'lstm'})
    env.reset()
    obs = np.asarray(env.observation(env.players()[0]), np.float32)
    wrapper = jax_load_model(ckpt, env)
    params, hidden = wrapper.params, wrapper.init_hidden((1,))

    def infer(o, h):
        return wrapper.module.apply(params, o, h)
    spec = jax.tree_util.tree_map(
        lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype), hidden)
    exported = jexport.export(jax.jit(infer))(
        jax.ShapeDtypeStruct((1,) + obs.shape, jnp.float32), spec)
    with open(out_path, 'wb') as f:
        f.write(exported.serialize())


def test_a_recurrent_export_carries_the_hidden_state(tmp_path):
    env_args = {'env': 'HungryGeese', 'net_kind': 'lstm'}
    net = make_env(env_args).net()
    net.reset_parameters(torch.Generator().manual_seed(6))
    ckpt = str(tmp_path / 'lstm.ckpt')
    with open(ckpt, 'wb') as f:
        f.write(params_bytes(net, dict(net.named_parameters())))
    pt2, jaxexp = str(tmp_path / 'lstm.pt2'), str(tmp_path / 'lstm.jaxexp')
    assert _script('torch_export_model').main(
        ['--net-kind', 'lstm', 'HungryGeese', ckpt, pt2]) == 0
    _jax_export_recurrent(ckpt, jaxexp)
    model = evaluation.load_model(pt2, make_env(env_args), device='cpu')
    jm = JaxExportedModel(jaxexp)
    hidden, jhidden = model.init_hidden(), jm.init_hidden()
    assert [h.shape for h in hidden] == [(1, 7, 11, 32)] * 2
    for h, jh in zip(hidden, jhidden):
        np.testing.assert_array_equal(h, np.asarray(jh))
    for obs in _observations('HungryGeese', n=6):
        got, want = model.inference(obs, hidden), jm.inference(obs, jhidden)
        assert sorted(got) == sorted(want) == ['hidden', 'policy', 'value']
        for k in ('policy', 'value'):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                       atol=TOL, err_msg=k)
        for h, jh in zip(got['hidden'], want['hidden']):
            np.testing.assert_allclose(h, np.asarray(jh), rtol=0, atol=TOL)
        hidden, jhidden = got['hidden'], want['hidden']
    assert float(np.abs(hidden[1]).max()) > 0    # the state moved
    # a None hidden starts from zeros, as the engine's does
    first = _observations('HungryGeese', n=1)[0]
    np.testing.assert_array_equal(
        model.inference(first)['policy'],
        model.inference(first, model.init_hidden())['policy'])
