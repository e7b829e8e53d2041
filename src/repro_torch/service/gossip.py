"""Push-gossip dissemination of per-region share estimates.

Port of ``repro/service/gossip.py`` (numpy only).

The paper's central claim is that mapping can be coordinated *without*
aggregating global network state at one node.  The regional control plane
(``service.regions``) applies the same principle to the multi-tenant
fairness layer: no region ever reads another region's live accounting.
Instead each region periodically publishes a versioned :class:`ShareRecord`
— its per-tenant committed compute, queued demand, and residual capacity —
and a :class:`GossipBus` spreads the records epidemically: every round,
every region pushes its *entire current view* (its own fresh record plus
the freshest record it has heard for every other region) to ``fanout``
uniformly-random peers, and receivers keep the per-origin record with the
highest version.

Complexity: one round costs exactly ``R * fanout`` messages (each carrying
at most R small records), independent of the node count ``n`` — the
coordination traffic the centralized plane would need scales with the
global state, flooding scales with ``n^2``; gossip is the bounded-message
middle the paper argues for.  Staleness: with fanout f, a new record
reaches all R regions in O(log_{f+1} R) rounds with high probability; the
regional plane's fairness error is bounded by how much shares can drift
within that window (see ``bench_messages.run_regional`` for the measured
fanout/staleness vs fairness-deviation tradeoff).

Determinism: peer choice comes from a seeded ``numpy`` Generator, so a
fixed seed reproduces the exact dissemination schedule — the property
tests rely on this.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShareRecord:
    """One region's published accounting snapshot.

    ``version`` is the origin's monotonic publication counter — the merge
    rule (highest version per origin wins) makes dissemination idempotent
    and order-independent, so duplicated or reordered pushes are harmless.
    """

    origin: int
    version: int
    committed: Mapping[str, float]  # tenant -> committed compute in origin
    queued: Mapping[str, float]  # tenant -> queued demand in origin
    residual_cap: float  # summed live residual node capacity
    # gateway node -> occupancy estimate in [0, 1] for the origin's own
    # gateways; remote regions fold these into chain costs so spanning
    # requests steer around hot gateways *before* probing them with a 2PC
    congestion: Mapping[int, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "committed", dict(self.committed))
        object.__setattr__(self, "queued", dict(self.queued))
        object.__setattr__(self, "congestion", dict(self.congestion))


class GossipBus:
    """In-process simulation of the push-gossip fabric, message-accounted
    as if the regions were remote.

    ``views[r]`` is region r's current belief: origin -> freshest
    :class:`ShareRecord` it has heard.  ``publish`` refreshes a region's
    own record (bumping its version); ``tick`` runs one synchronous gossip
    round.  ``fanout`` is clamped to ``R - 1`` (a region never pushes to
    itself), so a single-region plane gossips nothing and counts nothing.
    """

    def __init__(self, n_regions: int, *, fanout: int = 2, seed: int = 0):
        self.n_regions = int(n_regions)
        self.fanout = max(0, min(int(fanout), self.n_regions - 1))
        self.rng = np.random.default_rng(seed)
        self.views: list[dict[int, ShareRecord]] = [
            {} for _ in range(self.n_regions)
        ]
        self.messages_sent = 0
        self.records_sent = 0  # ShareRecords carried across all messages
        self.payload_sent = 0  # scalar fields carried (records x record size)
        self.rounds = 0
        # window baselines for snapshot(reset=True): the lifetime counters
        # above are never rewound (CI gates read them directly)
        self._win_base = {"rounds": 0, "messages_sent": 0,
                          "records_sent": 0, "payload_sent": 0}

    # -- publication / dissemination ----------------------------------------

    def publish(
        self,
        origin: int,
        committed: Mapping[str, float],
        queued: Mapping[str, float],
        residual_cap: float,
        congestion: Mapping[int, float] | None = None,
    ) -> ShareRecord:
        """Refresh ``origin``'s own record in its own view (no messages —
        dissemination only happens in :meth:`tick`)."""
        prev = self.views[origin].get(origin)
        rec = ShareRecord(
            origin=origin,
            version=(prev.version + 1) if prev is not None else 1,
            committed=committed,
            queued=queued,
            residual_cap=float(residual_cap),
            congestion=congestion if congestion is not None else {},
        )
        self.views[origin][origin] = rec
        return rec

    @staticmethod
    def _merge(view: dict[int, ShareRecord], payload: Mapping[int, ShareRecord]) -> None:
        for origin, rec in payload.items():
            cur = view.get(origin)
            if cur is None or rec.version > cur.version:
                view[origin] = rec

    def tick(self) -> int:
        """One synchronous gossip round: every region pushes its view (as
        of the round start — a push within a round does not relay) to
        ``fanout`` distinct random peers.  Returns the messages sent this
        round (exactly ``R * fanout`` for R > 1)."""
        self.rounds += 1
        if self.fanout == 0 or self.n_regions <= 1:
            return 0
        snap = [dict(v) for v in self.views]  # round-start freeze
        sent = 0
        for r in range(self.n_regions):
            peers = [p for p in range(self.n_regions) if p != r]
            idx = self.rng.choice(
                len(peers), size=min(self.fanout, len(peers)), replace=False
            )
            nrec = len(snap[r])
            size = sum(self._record_size(rec) for rec in snap[r].values())
            for i in np.sort(idx):  # deterministic merge order
                self._merge(self.views[peers[int(i)]], snap[r])
                sent += 1
                self.records_sent += nrec
                self.payload_sent += size
        self.messages_sent += sent
        return sent

    @staticmethod
    def _record_size(rec: ShareRecord) -> int:
        """Scalar fields one :class:`ShareRecord` carries on the wire:
        origin + version + residual_cap plus one (key, value) entry per
        committed/queued tenant and per congestion gateway."""
        return 3 + len(rec.committed) + len(rec.queued) + len(rec.congestion)

    def gossip_stats(self) -> dict:
        """Message/payload accounting for the bus's lifetime.  A flat
        R-region plane carries up to R records per message (every region
        pushes its whole view); the hierarchy's win is that each level's
        bus only ever carries ``branching`` *aggregated* records."""
        rounds = max(self.rounds, 1)
        msgs = max(self.messages_sent, 1)
        return {
            "n_regions": self.n_regions,
            "fanout": self.fanout,
            "rounds": self.rounds,
            "messages_sent": self.messages_sent,
            "records_sent": self.records_sent,
            "payload_sent": self.payload_sent,
            "messages_per_round": self.messages_sent / rounds,
            "records_per_round": self.records_sent / rounds,
            "payload_per_round": self.payload_sent / rounds,
            "records_per_message": self.records_sent / msgs,
        }

    def snapshot(self, *, reset: bool = False) -> dict:
        """Windowed :meth:`gossip_stats`: counters since the last
        ``snapshot(reset=True)`` (or construction).  ``reset=True`` closes
        the window — benchmark sweeps call this per point so rounds don't
        accumulate across points.  The lifetime counters
        (``messages_sent`` etc.) are baselined, never rewound."""
        win = {k: getattr(self, k) - v for k, v in self._win_base.items()}
        rounds = max(win["rounds"], 1)
        msgs = max(win["messages_sent"], 1)
        out = {
            "n_regions": self.n_regions,
            "fanout": self.fanout,
            **win,
            "messages_per_round": win["messages_sent"] / rounds,
            "records_per_round": win["records_sent"] / rounds,
            "payload_per_round": win["payload_sent"] / rounds,
            "records_per_message": win["records_sent"] / msgs,
        }
        if reset:
            self._win_base = {k: getattr(self, k) for k in self._win_base}
        return out

    # -- estimates -----------------------------------------------------------

    def remote_committed(self, region: int) -> dict[str, float]:
        """Region ``region``'s *estimate* of per-tenant committed compute in
        every other region: the sum of the freshest gossiped records.  May
        be arbitrarily stale — callers must treat it as advisory (drain
        ordering), never as capacity."""
        out: dict[str, float] = {}
        for origin, rec in self.views[region].items():
            if origin == region:
                continue
            for t, c in rec.committed.items():
                out[t] = out.get(t, 0.0) + float(c)
        return out

    def remote_queued(self, region: int) -> dict[str, float]:
        out: dict[str, float] = {}
        for origin, rec in self.views[region].items():
            if origin == region:
                continue
            for t, c in rec.queued.items():
                out[t] = out.get(t, 0.0) + float(c)
        return out

    def congestion_view(self, region: int) -> dict[int, float]:
        """Region ``region``'s belief about gateway occupancy across the
        plane: gateway node -> occupancy in [0, 1], folded from the
        freshest record heard per origin (including its own).  Each origin
        publishes only its own gateways, so keys are disjoint in practice;
        on overlap the max (most pessimistic) estimate wins.  Like every
        gossiped quantity this is advisory: chain *ranking* may use it,
        capacity admission never does."""
        out: dict[int, float] = {}
        for rec in self.views[region].values():
            for node, occ in rec.congestion.items():
                occ = float(occ)
                if occ > out.get(node, -1.0):
                    out[node] = occ
        return out

    def staleness(self, region: int) -> dict[int, int]:
        """Version lag of ``region``'s view per remote origin: 0 = current;
        a missing record counts the origin's full version history."""
        out: dict[int, int] = {}
        for origin in range(self.n_regions):
            if origin == region:
                continue
            latest = self.views[origin].get(origin)
            if latest is None:
                out[origin] = 0  # origin never published; nothing to know
                continue
            mine = self.views[region].get(origin)
            out[origin] = latest.version - (mine.version if mine else 0)
        return out

    def max_staleness(self) -> int:
        return max(
            (lag for r in range(self.n_regions)
             for lag in self.staleness(r).values()),
            default=0,
        )
