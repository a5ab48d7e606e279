"""Partition rules as checkpoint layout manifests.

The manifest part of ``handyrl_tpu/parallel/partition.py``: the rule
vocabulary (a regex over '/'-joined param paths, a :class:`PartitionSpec`
a rule) and ``checkpoint_layout``, the JSON dict written next to
``trainer_state.ckpt`` and ``models/<epoch>.ckpt`` (``utils/fs.py``), so a
checkpoint saved under one rank count restores under another with the
change logged, not assumed. The same JSON as the JAX package's, so each
package reads the other's manifests.

Data parallelism is the only layout here (``DEFAULT_RULES`` replicates
every parameter; the batch shards along 'data'). The rule engine that
maps rules onto a 'model' axis (``rules_from_config``,
``match_partition_rules``, ``validate_specs``, ``tree_shardings``,
``host_to_global_batch``) is ROADMAP.md section 1 item 5b.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from . import multihost
from .mesh import Mesh, PartitionSpec as P

# pure data parallelism: every parameter/optimizer leaf replicated, the
# batch sharded along 'data'
DEFAULT_RULES: Tuple[Tuple[str, P], ...] = ((r'.*', P()),)

# checkpoint layout-manifest format version (bump on incompatible change)
LAYOUT_FORMAT = 1


def spec_from_entry(entry) -> P:
    """Config-form spec -> PartitionSpec.

    ``None``/``[]`` replicate; a string names one mesh axis; a list maps
    array dims to axes positionally, with ``None``/``'null'``/``''``
    entries unsharded (``['data']`` -> P('data'), ``[None, 'model']`` ->
    P(None, 'model'))."""
    if entry is None:
        return P()
    if isinstance(entry, P):
        return entry
    if isinstance(entry, str):
        return P(entry)
    axes = [None if a in (None, 'null', '') else str(a) for a in entry]
    return P(*axes)


def normalize_rules(rules) -> Tuple[Tuple[str, P], ...]:
    """[(regex, config-form spec), ...] -> ((regex, PartitionSpec), ...)."""
    return tuple((str(pattern), spec_from_entry(spec))
                 for pattern, spec in rules)


def pure_data_parallel(rules) -> bool:
    """True when every rule replicates (no tensor-parallel specs): the
    precondition of the sharded fused loop, whose gradient sum assumes a
    fully replicated train state."""
    return all(len(tuple(spec)) == 0 for _, spec in normalize_rules(rules))


def serializable_rules(rules) -> list:
    """((regex, PartitionSpec), ...) -> JSON-safe [[regex, [axes...]], ...]."""
    out = []
    for pattern, spec in normalize_rules(rules):
        out.append([pattern, [list(a) if isinstance(a, (tuple, list))
                              else a for a in spec]])
    return out


def checkpoint_layout(mesh: Optional[Mesh], rules=DEFAULT_RULES,
                      steps: Optional[int] = None) -> Dict[str, Any]:
    """The layout manifest of a checkpoint's train state at save time. The
    state itself is serialized as full host arrays, so a restore under
    any rank count is exact; the manifest makes the change explicit.
    ``processes`` is the job's world size."""
    layout: Dict[str, Any] = {
        'format': LAYOUT_FORMAT,
        'mesh': (dict(mesh.shape) if mesh is not None else None),
        'devices': mesh.size if mesh is not None else 1,
        'processes': multihost.process_count(),
        'partition_rules': serializable_rules(rules),
    }
    if steps is not None:
        layout['steps'] = int(steps)
    return layout


def describe_mesh(layout: Optional[Dict[str, Any]]) -> str:
    """Human-readable mesh description of a layout manifest (logging)."""
    if not layout or not layout.get('mesh'):
        return 'single device'
    mesh = layout['mesh']
    return 'x'.join('%s=%d' % (axis, mesh[axis]) for axis in sorted(mesh))
