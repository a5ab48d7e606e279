"""League helpers: the slot plan of the device actor backend.

The port of ``plan_slots`` from ``handyrl_tpu/league.py``, which
``device_generation.DeviceActorEngine`` uses to pack a block of ledger
tasks' model ids into its fixed stack of parameter slots. The rest of the
JAX module (the ``LeaguePool`` over the registry, PFSP opponent sampling,
the ``RatingBook`` and its journal, rating-gated promotion) is the league
plane, which the port does not have yet (ROADMAP.md); ``config.validate``
refuses ``league.enabled``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def plan_slots(task_mids: Sequence[Sequence[int]], slots: int
               ) -> Tuple[Dict[int, int], List[bool]]:
    """Pack a block of tasks' model ids into a fixed device slot stack.

    ``task_mids[i]`` lists the model ids task ``i`` needs on the device
    (its slot-backed seats). Tasks are admitted in order while their ids
    still fit into ``slots`` distinct entries; a task whose new ids would
    overflow the stack is skipped (False) and runs on the host fallback
    instead. Ids below 1 never claim a slot. Returns ``(assign,
    admitted)``: the mid -> slot map and the per-task verdicts."""
    assign: Dict[int, int] = {}
    admitted: List[bool] = []
    for mids in task_mids:
        new = sorted({int(m) for m in mids if int(m) >= 1} - set(assign))
        if len(assign) + len(new) > int(slots):
            admitted.append(False)
            continue
        for m in new:
            assign[m] = len(assign)
        admitted.append(True)
    return assign, admitted
