"""Defaults of the ``inference`` and ``serving`` config blocks.

The subset of ``handyrl_tpu/config.py`` the serving path reads, as plain
dicts (the port parses no YAML). Differences from the JAX package: the
engine runs on the device given to the service (``--device``, default
'cuda'), so ``inference.engine_backend`` does not exist here, and the fleet,
gateway, metrics-exporter and alert knobs wait for their modules.
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
