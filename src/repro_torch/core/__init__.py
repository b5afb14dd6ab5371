"""CMM core on torch: lazy expressions, fusion, tiling, HEFT, simulation
and the engine."""
from .lazy import ClusteredMatrix, Op, eager_eval, topo_order  # noqa: F401
from .graph import Task, TaskGraph, TaskKind, TileRef          # noqa: F401
from .tiling import tile_expression, TiledProgram              # noqa: F401
from .machine import ClusterSpec, c5_9xlarge, hetero_spec      # noqa: F401
from .timemodel import (TimeModel, PolyModel, CostCache,       # noqa: F401
                        analytic_time_model)
from .cache import NodeCache                                   # noqa: F401
from .heft import heft_schedule, Schedule                      # noqa: F401
from .simulator import simulate, SimResult                     # noqa: F401
from .engine import CMMEngine, Plan                            # noqa: F401
from .fusion import (FusionReport, eval_fused, optimize,       # noqa: F401
                     optimize_many, structural_signature)
