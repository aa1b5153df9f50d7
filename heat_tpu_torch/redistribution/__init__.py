"""Planned redistribution (``ht.redistribution``; port of
``heat_tpu.redistribution``).

Split changes (``resplit``) and reshapes with repartition
(``ht.reshape(..., new_split=)``) are planned before they run:

- :mod:`~.spec`: :class:`RedistSpec`, the normalized problem statement;
- :mod:`~.planner`: the cost model that chooses among all-to-all, chunked
  all-to-all, the ring, the split-0 pivot, the packed pivot (kernels K5
  and K6) and the explicit gather, with ``heat_tpu``'s plans byte for byte;
- :mod:`~.schedule`: the inspectable plan, with its collective census;
- :mod:`~.executor`: the per-rank programs over the communicator's
  collectives;
- :mod:`~.staging`: out-of-core operands (``HostArray``) streamed through
  the card in windows, with their ``host-staging`` plans.

``ht.redistribution.explain(arr, axis)`` (or ``reshape=...``) returns the
plan that the public call runs; ``.describe()`` renders it.
"""

from . import executor, planner, schedule, spec, staging
from . import schedule as schedule_ir  # heat_tpu's names of the two modules
from . import spec as spec_mod
from .executor import LocalWorld, execute, reshape_local, resplit_local
from .planner import budget_bytes, clear_plan_cache, explain, golden_specs, plan, planner_enabled
from .schedule import Schedule, Step
from .spec import RedistSpec
from .staging import HostArray, ooc_mode, plan_staged_passes, prove_fits

__all__ = [
    "HostArray",
    "LocalWorld",
    "RedistSpec",
    "Schedule",
    "Step",
    "budget_bytes",
    "clear_plan_cache",
    "execute",
    "explain",
    "golden_specs",
    "ooc_mode",
    "plan",
    "plan_staged_passes",
    "planner_enabled",
    "prove_fits",
    "reshape_local",
    "resplit_local",
]
