"""``python -m handyrl_tpu_torch MODE [ARGS...] [--config FILE.json]
[--device cuda|cpu]``: the port's ``main.py``.

The JAX package's modes, dispatched to the port's entry points:
``--train``/``-t`` and ``--train-server``/``-ts`` (``train.train_main``),
``--worker``/``-w [NUM_PARALLEL]`` (``worker.worker_main``),
``--eval``/``-e``, ``--eval-server``/``-es`` and ``--eval-client``/``-ec``
(``evaluation``), ``--serve``/``-sv`` (``serving.service.serve_main``),
``--serve-fleet``/``-sf`` (``serving.fleet.resolver_main``: the resolver
and ``serving.fleet.replicas`` managed replicas) and ``--gateway``/``-gw``
(``serving.gateway.gateway_main``, over the resolver at
``serving.gateway.resolver`` or ``serving.fleet.resolver``).
The config is JSON with the ``env_args``, ``train_args`` and
``worker_args`` blocks of ``config.yaml`` (``tictactoe.json`` is
config.yaml's); without ``--config`` the defaults (TicTacToe). ``--serve``
reads its service's knobs from ``train_args.serving`` and
``train_args.inference``, as the JAX ``serve_main`` does, and serves the
registry under ``serving.registry_dir``, else under ``model_dir``
(where the learner of the same config publishes), else under
``models``; ``--serve-fleet`` and ``--gateway`` read the same blocks
(the gateway also ``seed`` and ``league``); the learner's modes take only
the learner's keys there (``config.validate``). With
``serving.fleet.resolver`` set, ``--serve`` registers as a fleet replica.
The serving modes take the ``telemetry`` block too (tracing, alerts,
the flight recorder), and each tier's ``metrics_port``
(``serving.metrics_port``, ``serving.fleet.metrics_port``,
``serving.gateway.metrics_port``) starts its exporter.
``--status [HOST:PORT] [--json]`` (``telemetry.status_main``) renders
a live ``/statusz``: a learner's (its ``telemetry_port``; without a
target, the config's ``telemetry_port`` on localhost), a service's, a
resolver's or a gateway's, and exits 1 when the fetch fails, as the JAX
``main.py --status`` does.
The device is the card unless ``--device cpu`` is given (a fleet's
replicas run on it too); the eval server, the gateway and ``--status``
load no model and ignore it.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

USAGE = """usage: python main.py MODE [args]
modes:
  --train, -t          stand-alone training on this host
  --train-server, -ts  training server awaiting remote workers
  --worker, -w         worker host feeding a training server [num_parallel]
  --eval, -e           evaluate MODEL_PATH[:OPPONENT] [NUM_GAMES [NUM_PROC]]
  --eval-server, -es   network battle server [NUM_GAMES [NUM_PROC]]
  --eval-client, -ec   network battle client MODEL_PATH [HOST]
  --serve, -sv         standalone model-serving tier (registry-versioned
                       inference service; SIGTERM drains and exits 75)
  --serve-fleet, -sf   replicated serving fleet: resolver/router +
                       serving.fleet.replicas managed replicas (SLO-driven
                       autoscaling, zero-loss failover, rolling promotes)
  --gateway, -gw       match gateway over a serving fleet: server-held
                       game sessions (open/play/close), drain handoff +
                       journal-replay reconstruction, outcomes -> RatingBook
  --status             render a live /statusz health view [HOST:PORT]
                       (active alerts, fleet states, progress, recorder)
"""

SERVING_MODES = ('--serve', '-sv', '--serve-fleet', '-sf', '--gateway',
                 '-gw')


def serving_main(mode: str, raw: Dict, device: str) -> int:
    """The serving tier's modes on the config's ``train_args.serving``,
    ``train_args.inference`` and ``train_args.telemetry`` blocks
    (``config.serving_args``)."""
    from .config import serving_args
    ta = raw.get('train_args', {})
    serving = dict(ta.get('serving') or {})
    # the registry root as the JAX service resolves it: the serving
    # block's, else the learner's model_dir, where it publishes
    serving['registry_dir'] = (serving.get('registry_dir')
                               or ta.get('model_dir') or 'models')
    args = serving_args(raw.get('env_args', {'env': 'TicTacToe'}),
                        ta.get('inference'), serving,
                        telemetry=ta.get('telemetry', True))
    if mode in ('--serve-fleet', '-sf'):
        from .serving.fleet import resolver_main
        return resolver_main(args, device=device)
    if mode in ('--gateway', '-gw'):
        from .serving.gateway import gateway_main
        args['seed'] = ta.get('seed', 0)
        args['league'] = ta.get('league') or {}
        return gateway_main(args)
    from .serving.service import serve_main
    return serve_main(args, device=device)


def split_options(argv: List[str]) -> Tuple[Dict[str, Optional[str]],
                                            List[str]]:
    """``--config`` and ``--device`` (``--opt VALUE`` or ``--opt=VALUE``,
    anywhere) apart from the mode and its arguments."""
    opts: Dict[str, Optional[str]] = {'--config': None, '--device': 'cuda'}
    rest: List[str] = []
    it = iter(argv)
    for arg in it:
        key, eq, value = arg.partition('=')
        if key in opts:
            value = value if eq else next(it, None)
            if value is None:
                raise SystemExit('%s needs a value' % key)
            opts[key] = value
        else:
            rest.append(arg)
    return opts, rest


def main(argv: Optional[List[str]] = None) -> int:
    opts, rest = split_options(sys.argv[1:] if argv is None else list(argv))
    if not rest:
        print(USAGE)
        return 1
    mode, rest = rest[0], rest[1:]
    device = opts['--device']
    raw = {}
    if opts['--config']:
        with open(opts['--config']) as f:
            raw = json.load(f)

    if mode in SERVING_MODES:
        return serving_main(mode, raw, device)

    from .config import apply_defaults
    args = apply_defaults(raw)
    if mode in ('--train', '-t', '--train-server', '-ts'):
        from .train import train_main
        return train_main(args, device,
                          server=mode in ('--train-server', '-ts'))
    if mode in ('--worker', '-w'):
        from .model import resolve_device
        from .worker import worker_main
        args['worker_args']['device'] = str(resolve_device(device))
        return worker_main(args, rest)
    if mode in ('--eval', '-e'):
        from .evaluation import eval_main
        eval_main(args, rest, device=device)
        return 0
    if mode in ('--eval-server', '-es'):
        from .evaluation import eval_server_main
        eval_server_main(args, rest)
        return 0
    if mode in ('--eval-client', '-ec'):
        from .evaluation import eval_client_main
        return eval_client_main(args, rest, device=device)
    if mode == '--status':
        from .telemetry import status_main
        try:
            status_main(args['train_args'], rest)
        except SystemExit as exc:
            return int(exc.code or 0)
        return 0
    print('Not found mode %s.' % mode)
    print(USAGE)
    return 1


if __name__ == '__main__':
    sys.exit(main())
