"""Core of the PyTorch/CUDA port (mirrors ``repro.core``).

Ported so far:
  problem:     BIG sentinel + feasibility epsilons, request tensors
  compact:     CompactedView — global<->local id bijection; region-local
               compacted solves (n_r-sized tensors, read/write-through)
  graph:       ResourceGraph, DataflowPath, Mapping, validate_mapping
  topology:    waxman / barabasi_albert / region_* generators, random_dataflow
  exact:       pathmap_exact (paper Alg. 1-3), brute_force oracle
  leastcost:   leastcost_python (faithful), leastcost_torch[_batched]
  simulator:   simulate (paper Alg. 4, async message passing, §3.4 policies)
  distributed: leastcost_shard_map (decentralized, torch.distributed ranks)
  heuristics:  anneal_python (§3.4.2), random_k_python (§3.4.3)
  dag:         treemap_leastcost (paper §4 future-work extension)
  reconstruct: parent-pointer backtrack + sound fallback
  engine:      solve / solve_batch / solve_batch_dispatch
  residual:    ResidualState — device-resident residual tensors
  solution_cache: SolutionCache behind the incremental admission fast path
  online:      OnlinePlacer + AdmissionPipeline
  carry:       state carried across from the JAX package as numpy arrays
"""
from .problem import BIG  # noqa: F401
from .compact import CompactedView, compact_view  # noqa: F401
from .graph import (  # noqa: F401
    DataflowPath,
    Mapping,
    ResourceGraph,
    mapping_cost,
    route_from_assign,
    validate_mapping,
)
from .exact import ExactStats, brute_force, pathmap_exact  # noqa: F401
from .leastcost import (  # noqa: F401
    HeuristicStats,
    leastcost_python,
    leastcost_torch,
    leastcost_torch_batched,
)
from .simulator import SimConfig, SimStats, simulate  # noqa: F401
from .heuristics import anneal_python, random_k_python  # noqa: F401
from .dag import DataflowTree, TreeMapping, treemap_leastcost  # noqa: F401
from .distributed import DistStats, leastcost_shard_map  # noqa: F401
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
