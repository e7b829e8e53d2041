"""Core of the PyTorch/CUDA port (mirrors ``repro.core``).

This slice ports the online admission path:
  problem:     BIG sentinel + feasibility epsilons, request tensors
  graph:       ResourceGraph, DataflowPath, Mapping, validate_mapping
  topology:    waxman / barabasi_albert / region_* generators, random_dataflow
  leastcost:   leastcost_python (faithful), leastcost_torch[_batched]
  reconstruct: parent-pointer backtrack + sound fallback
  engine:      solve / solve_batch / solve_batch_dispatch
  residual:    ResidualState — device-resident residual tensors
  solution_cache: SolutionCache behind the incremental admission fast path
  online:      OnlinePlacer + AdmissionPipeline
  carry:       state carried across from the JAX package as numpy arrays
"""
from .problem import BIG  # noqa: F401
from .graph import (  # noqa: F401
    DataflowPath,
    Mapping,
    ResourceGraph,
    mapping_cost,
    route_from_assign,
    validate_mapping,
)
from .leastcost import (  # noqa: F401
    HeuristicStats,
    leastcost_python,
    leastcost_torch,
    leastcost_torch_batched,
)
from .engine import (  # noqa: F401
    Stats,
    backends,
    register,
    solve,
    solve_batch,
    solve_batch_dispatch,
)
from .online import (  # noqa: F401
    AdmissionPipeline,
    OnlinePlacer,
    OnlineStats,
    PendingAdmission,
    Ticket,
)
from .residual import ResidualState  # noqa: F401
from .solution_cache import SolutionCache, request_signature  # noqa: F401
from .carry import graph_from_numpy, residual_from_snapshot  # noqa: F401
from .topology import (  # noqa: F401
    barabasi_albert,
    paper_example,
    random_dataflow,
    region_grid,
    region_line,
    region_tree,
    waxman,
)
