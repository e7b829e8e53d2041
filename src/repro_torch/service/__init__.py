"""Multi-tenant placement control plane (service layer).

Port of ``repro/service``: the planes are numpy on the host and solve
through the port's ``OnlinePlacer``, so every region-local solve runs the
batched superstep kernel on the plane's ``device``.

The layer between ``core.online.OnlinePlacer`` and the launch/serving
front ends:

  policy:       TenantConfig, weighted max-min shares (water-filling),
                FairSharePolicy drain scheduling, preemption-class rules
  controlplane: ControlPlane — per-tenant queues, fair admission into
                ``admit_many`` micro-batches, preemption, churn
                reconciliation, conservation ledger
  defrag:       atomic global re-optimization of the standing ticket set
  gossip:       GossipBus — push-gossip of versioned per-region share
                estimates (R * fanout messages per round)
  regions:      RegionalControlPlane — R sharded planes over compacted
                region-local subgraphs (core.compact views: every solve
                sized n_r, not n), coordinated only by gossip + one
                bounded 2PC per spanning dataflow over its multi-hop
                region chain; constructed by ``ControlPlane(rg,
                regions=R)``, bit-identical to the centralized plane at
                R = 1
  hierarchy:    HierarchicalControlPlane — regions of regions: per-level
                brokers that translate ids only at their own boundary,
                recursive spanning decomposition, tree-structured gossip
                (O(branching * fanout) msgs/round per level); constructed
                by ``ControlPlane(rg, levels=L, branching=b)``,
                bit-identical to the flat regional plane at levels = 1
"""
from .controlplane import ControlPlane, Request, TenantState  # noqa: F401
from .defrag import DefragResult, defrag, global_objective  # noqa: F401
from .gossip import GossipBus, ShareRecord  # noqa: F401
from .hierarchy import (  # noqa: F401
    HierarchicalControlPlane,
    resolve_nesting,
)
from .regions import (  # noqa: F401
    ChainBroker,
    RegionalControlPlane,
    SpanPart,
    SpanningTicket,
    cut_edges,
    partition_regions,
    region_subgraph,
    split_dataflow,
    split_dataflow_chain,
    validate_region_of,
)
from .policy import (  # noqa: F401
    CLASS_BEST_EFFORT,
    CLASS_CRITICAL,
    CLASS_STANDARD,
    FairSharePolicy,
    TenantConfig,
    fairness_summary,
    maxmin_shares,
    may_preempt,
)
