"""Standalone serving runner: ``python -m handyrl_tpu_torch.serving [flags]``.

Every knob is a flag (no YAML); defaults come from config.py. Three
modes, as the JAX package's runner: one service (a fleet replica with
``--resolver``), a fleet resolver with its managed replicas (``--fleet``)
and a match gateway over a fleet (``--gateway``). The models run on
``--device`` ('cuda' by default: without a CUDA device the runner exits
with an error unless ``--device cpu`` is given); a fleet's replicas run on
the same device. The ready line on stdout carries the bound port. The
exit code follows the PreemptionGuard contract: 75 after a SIGTERM drain
(or a drain the resolver directs). ``--metrics-port`` starts the
service's Prometheus exporter (``serving.metrics_port``), and the
gateway's with ``--gateway`` (``serving.gateway.metrics_port``), as in
the JAX runner; a managed replica inherits tracing through the
environment, not through a flag.
"""

from __future__ import annotations

import argparse


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog='python -m handyrl_tpu_torch.serving',
        description='standalone handyrl_tpu_torch inference service, fleet '
                    'resolver or match gateway')
    ap.add_argument('--env', default='TicTacToe',
                    help='environment name (builds the example observation '
                         'the engines materialize snapshots against)')
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
    ap.add_argument('--metrics-port', type=int, default=0,
                    help='Prometheus /metrics and /statusz port (0 = '
                         'exporter off)')
    ap.add_argument('--wait-ms', type=float, default=None,
                    help='override inference.batch_wait_ms')
    ap.add_argument('--max-batch', type=int, default=None,
                    help='override inference.max_batch')
    ap.add_argument('--device', default='cuda',
                    help="device the engines run on: 'cuda' (default) or "
                         "'cpu'")
    # fleet membership (replica mode): register and heartbeat with a
    # resolver; a drain it directs exits 75 as a SIGTERM drain does
    ap.add_argument('--resolver', default='',
                    help='fleet resolver endpoint (host:port) to register '
                         'with (serving.fleet.resolver)')
    ap.add_argument('--replica', default='',
                    help='fleet replica name to register under (default: '
                         'assigned by the resolver)')
    ap.add_argument('--heartbeat', type=float, default=None,
                    help='override serving.fleet.heartbeat_interval')
    ap.add_argument('--heartbeat-timeout', type=float, default=None,
                    help='override serving.fleet.heartbeat_timeout')
    # resolver mode: the fleet's control plane and its managed replicas
    ap.add_argument('--fleet', action='store_true',
                    help='run a fleet resolver (and --replicas managed '
                         'replica processes) instead of one service')
    ap.add_argument('--replicas', type=int, default=None,
                    help='managed replicas the resolver spawns '
                         '(serving.fleet.replicas)')
    ap.add_argument('--min-replicas', type=int, default=None)
    ap.add_argument('--max-replicas', type=int, default=None)
    ap.add_argument('--autoscale', action='store_true',
                    help='enable the SLO-driven autoscaler')
    ap.add_argument('--slo-p99-ms', type=float, default=None,
                    help='autoscaler p99 latency target '
                         '(serving.fleet.slo_p99_ms)')
    # gateway mode: game sessions over a running fleet resolver
    ap.add_argument('--gateway', action='store_true',
                    help='run a match gateway (game sessions held by the '
                         'server over a fleet resolver) instead of a '
                         'service')
    ap.add_argument('--gateway-model', default=None,
                    help='default opponent model spec '
                         '(serving.gateway.model)')
    ap.add_argument('--gateway-workers', type=int, default=None,
                    help='session worker threads (serving.gateway.workers)')
    ap.add_argument('--max-sessions', type=int, default=None,
                    help='admission-control ceiling '
                         '(serving.gateway.max_sessions)')
    ap.add_argument('--ply-timeout', type=float, default=None,
                    help='per-ply inference deadline '
                         '(serving.gateway.ply_timeout)')
    ap.add_argument('--seed', type=int, default=None,
                    help='base seed of the audited per-session env seeds')
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    from ..config import serving_args

    inference = {}
    if args.wait_ms is not None:
        inference['batch_wait_ms'] = float(args.wait_ms)
    if args.max_batch is not None:
        inference['max_batch'] = int(args.max_batch)
    fleet, gateway = {}, {}
    if args.gateway:
        gateway['port'] = args.port
        gateway['metrics_port'] = args.metrics_port
        if args.resolver:
            gateway['resolver'] = args.resolver
        if args.gateway_model is not None:
            gateway['model'] = args.gateway_model
        if args.gateway_workers is not None:
            gateway['workers'] = int(args.gateway_workers)
        if args.max_sessions is not None:
            gateway['max_sessions'] = int(args.max_sessions)
        if args.ply_timeout is not None:
            gateway['ply_timeout'] = float(args.ply_timeout)
    if args.resolver:
        fleet['resolver'] = args.resolver
    if args.replica:
        fleet['replica'] = args.replica
    if args.heartbeat is not None:
        fleet['heartbeat_interval'] = float(args.heartbeat)
    if args.heartbeat_timeout is not None:
        fleet['heartbeat_timeout'] = float(args.heartbeat_timeout)
    if args.fleet:
        fleet['port'] = args.port
        if args.replicas is not None:
            fleet['replicas'] = int(args.replicas)
        if args.min_replicas is not None:
            fleet['min_replicas'] = int(args.min_replicas)
        if args.max_replicas is not None:
            fleet['max_replicas'] = int(args.max_replicas)
        if args.autoscale:
            fleet['autoscale'] = True
        if args.slo_p99_ms is not None:
            fleet['slo_p99_ms'] = float(args.slo_p99_ms)
    cfg = serving_args(
        {'env': args.env}, inference,
        {'port': 0 if args.gateway else args.port, 'host': args.host,
         'line': args.line, 'registry_dir': args.registry,
         'engines': args.engines, 'max_clients': args.max_clients,
         'drain_timeout': args.drain_timeout,
         'metrics_port': args.metrics_port, 'fleet': fleet,
         'gateway': gateway})
    if args.gateway:
        from .gateway import gateway_main
        if args.seed is not None:
            cfg['seed'] = int(args.seed)
        return gateway_main(cfg)
    if args.fleet:
        from .fleet import resolver_main
        return resolver_main(cfg, device=args.device)
    from .service import serve_main
    return serve_main(cfg, device=args.device)


if __name__ == '__main__':
    raise SystemExit(main())
