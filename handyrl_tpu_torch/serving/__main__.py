"""Standalone service runner: ``python -m handyrl_tpu_torch.serving [flags]``.

Every knob is a flag (no YAML); defaults come from config.py. The models
run on ``--device`` ('cuda' by default: without a CUDA device the runner
exits with an error unless ``--device cpu`` is given). The ready line on
stdout carries the bound port. The exit code follows the PreemptionGuard
contract: 75 after a SIGTERM drain.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m handyrl_tpu_torch.serving',
        description='standalone handyrl_tpu_torch inference service')
    ap.add_argument('--env', default='HungryGeese',
                    help='environment name (builds the example observation)')
    ap.add_argument('--registry', default='models',
                    help='model-registry root (serving.registry_dir)')
    ap.add_argument('--port', type=int, default=0,
                    help='listen port (0 = ephemeral, reported on the '
                         'ready line)')
    ap.add_argument('--host', default='', help='bind host')
    ap.add_argument('--line', default='default',
                    help='default model line for bare-integer request ids')
    ap.add_argument('--engines', type=int, default=1)
    ap.add_argument('--max-clients', type=int, default=64)
    ap.add_argument('--drain-timeout', type=float, default=30.0)
    ap.add_argument('--wait-ms', type=float, default=None,
                    help='override inference.batch_wait_ms')
    ap.add_argument('--max-batch', type=int, default=None,
                    help='override inference.max_batch')
    ap.add_argument('--device', default='cuda',
                    help="device the engines run on: 'cuda' (default) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    from ..config import serving_args
    from .service import serve_main

    inference = {}
    if args.wait_ms is not None:
        inference['batch_wait_ms'] = float(args.wait_ms)
    if args.max_batch is not None:
        inference['max_batch'] = int(args.max_batch)
    cfg = serving_args(
        {'env': args.env}, inference,
        {'port': args.port, 'host': args.host, 'line': args.line,
         'registry_dir': args.registry, 'engines': args.engines,
         'max_clients': args.max_clients,
         'drain_timeout': args.drain_timeout})
    return serve_main(cfg, device=args.device)


if __name__ == '__main__':
    raise SystemExit(main())
