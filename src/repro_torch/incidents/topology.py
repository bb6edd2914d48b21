"""Fleet topology: the tiered rank -> host -> switch -> pod placement map
the incident tier joins on.

Per-job evidence is rank-indexed; physical faults are fabric-indexed —
and "When Scaling Fails" shows the fabric tiers above the host
(oversubscribed uplinks, flapping switches, pod-wide congestion)
dominate many production slowdowns.  The `Topology` therefore holds a
HIERARCHY, not a flat map:

    rank --(per-job placement)--> host --(fabric)--> switch --> pod

so the incident engine can (a) merge two rank-candidates of one job that
share a node into one rank-set incident, (b) correlate incidents ACROSS
jobs that share a node, and (c) promote each co-activation set to the
*narrowest tier that explains it* — three faulted hosts under one switch
are ONE switch incident, not three host incidents.

Placements arrive two ways, both landing here:

  * statically, from a `sim.ClusterSpec` / an operator-provided map
    (`Topology.from_jobs` with optional per-rank switch/pod tuples);
  * dynamically, from the wire: SFP2-v2 packets carry per-rank host
    ids and SFP2-v3 packets additionally carry per-rank switch/pod ids;
    `FleetService` declares each job's placement as packets arrive.

The fabric maps are fleet-global (a host has ONE switch, a switch ONE
pod, regardless of which job observed it) and *last-writer-wins*: a
conflicting claim — a rank re-homed to a different host mid-run, a host
re-cabled under a different switch — overwrites the previous placement
and increments the `rehomed` counter, which `FleetService.snapshot()`
surfaces so operators can see churn instead of silent drift.  Lower
tiers are derivable from upper ones: declaring `(host, switch, pod)`
also declares `(switch, pod)`; a host with no declared switch simply
cannot be switch- or pod-correlated (the engine keeps its evidence at
the host tier rather than guessing).

A job with no declared placement cannot be correlated at any tier — its
incidents stay job-scoped.

Writes are serialized by a lock: a sharded fleet's lanes declare into the
coordinator's one `Topology` from several threads at once, and `rehomed`
is a read-modify-write.
"""
from __future__ import annotations

import threading
from typing import Mapping, Sequence

__all__ = ["TIERS", "Topology"]

#: attribution tiers, narrowest first — the order the incident engine
#: promotes in (host evidence claims members before switch, switch
#: before pod).
TIERS = ("host", "switch", "pod")


class Topology:
    """Mutable tiered fleet placement map with deterministic indexing."""

    def __init__(self):
        self._jobs: dict[str, tuple[str, ...]] = {}
        #: fabric maps, fleet-global: host -> switch, switch -> pod.
        self._switch_of: dict[str, str] = {}
        self._pod_of: dict[str, str] = {}
        #: conflicting-claim counter (last-writer-wins re-homings): a
        #: rank moved to a different host, a host to a different switch,
        #: or a switch to a different pod.  Monotonic; surfaced in
        #: `FleetService.snapshot()["rehomed"]`.
        self.rehomed = 0
        #: held by every write (`declare` takes it around `declare_fabric`)
        self._lock = threading.RLock()

    @classmethod
    def from_jobs(
        cls,
        placements: Mapping[str, Sequence[str]],
        *,
        switches: Mapping[str, Sequence[str]] | None = None,
        pods: Mapping[str, Sequence[str]] | None = None,
    ) -> "Topology":
        """Build from `{job_id: per-rank host names}` (+ optional
        per-rank switch/pod names, aligned with the host tuples)."""
        t = cls()
        for job_id, hosts in placements.items():
            t.declare(
                job_id,
                hosts,
                switches=(switches or {}).get(job_id, ()),
                pods=(pods or {}).get(job_id, ()),
            )
        return t

    # -- writes ------------------------------------------------------------

    def declare(
        self,
        job_id: str,
        hosts: Sequence[str],
        *,
        switches: Sequence[str] = (),
        pods: Sequence[str] = (),
    ) -> None:
        """Declare (or replace) one job's per-rank placement.

        An empty `hosts` is a no-op: packets without the host section
        must never erase a previously declared placement.  Non-empty
        `switches` / `pods` must align with `hosts` per rank; they feed
        the fleet-global fabric maps (`declare_fabric` per host).
        Conflicting re-declarations win (last writer) and count into
        `rehomed` — one count per rank whose host actually changed.
        """
        hosts = tuple(str(h) for h in hosts)
        if not hosts:
            return
        switches = tuple(str(s) for s in switches)
        pods = tuple(str(p) for p in pods)
        if switches and len(switches) != len(hosts):
            raise ValueError(
                f"switches must align with hosts: {len(switches)} != "
                f"{len(hosts)}"
            )
        if pods and len(pods) != len(hosts):
            raise ValueError(
                f"pods must align with hosts: {len(pods)} != {len(hosts)}"
            )
        with self._lock:
            prev = self._jobs.get(job_id, ())
            self.rehomed += sum(
                1
                for r in range(min(len(prev), len(hosts)))
                if prev[r] != hosts[r]
            )
            self._jobs[job_id] = hosts
            for r, h in enumerate(hosts):
                self.declare_fabric(
                    h,
                    switch=switches[r] if switches else "",
                    pod=pods[r] if pods else "",
                )

    def declare_fabric(
        self, host: str, *, switch: str = "", pod: str = ""
    ) -> None:
        """Declare one host's fabric placement (host -> switch -> pod).

        Empty tiers are no-ops (a v2 packet never erases a v3 claim);
        a pod claim requires a switch to hang it from.  Conflicting
        claims are last-writer-wins and counted into `rehomed`.
        """
        switch, pod = str(switch), str(pod)
        if not switch:
            if pod:
                raise ValueError(
                    f"pod {pod!r} declared for host {host!r} without a switch"
                )
            return
        with self._lock:
            prev = self._switch_of.get(host, "")
            if prev and prev != switch:
                self.rehomed += 1
            self._switch_of[host] = switch
            if pod:
                prev = self._pod_of.get(switch, "")
                if prev and prev != pod:
                    self.rehomed += 1
                self._pod_of[switch] = pod

    def forget(self, job_id: str) -> None:
        """Drop a job's placement (eviction path — bounded state).

        Fabric maps persist: the cabling outlives any one job, and the
        engine only reaches fabric nodes through live jobs' hosts."""
        with self._lock:
            self._jobs.pop(job_id, None)

    # -- reads (host tier, the PR-8 surface) -------------------------------

    def host_of(self, job_id: str, rank: int) -> str:
        """Host of one rank ("" when the job or rank is undeclared)."""
        hosts = self._jobs.get(job_id, ())
        return hosts[rank] if 0 <= rank < len(hosts) else ""

    def hosts_for(self, job_id: str) -> tuple[str, ...]:
        return self._jobs.get(job_id, ())

    def jobs(self) -> tuple[str, ...]:
        """Declared job ids, sorted (deterministic iteration order)."""
        return tuple(sorted(self._jobs))

    def hosts(self) -> tuple[str, ...]:
        """Every distinct host name, sorted — the canonical host axis."""
        seen: set[str] = set()
        for hs in self._jobs.values():
            seen.update(hs)
        return tuple(sorted(seen))

    def host_index(self) -> dict[str, int]:
        """host name -> dense index over `hosts()` (the kernel's H axis)."""
        return {h: i for i, h in enumerate(self.hosts())}

    def jobs_on(self, host: str) -> tuple[str, ...]:
        """Jobs with at least one rank on `host`, sorted."""
        return tuple(
            sorted(j for j, hs in self._jobs.items() if host in hs)
        )

    def ranks_on(self, job_id: str, host: str) -> tuple[int, ...]:
        """Ranks of `job_id` served by `host`."""
        return tuple(
            r
            for r, h in enumerate(self._jobs.get(job_id, ()))
            if h == host
        )

    # -- reads (fabric tiers) ----------------------------------------------

    def switch_of(self, host: str) -> str:
        """Declared switch above `host` ("" = fabric undeclared)."""
        return self._switch_of.get(host, "")

    def pod_of_switch(self, switch: str) -> str:
        """Declared pod above `switch` ("" = undeclared)."""
        return self._pod_of.get(switch, "")

    def pod_of(self, host: str) -> str:
        """Declared pod above `host` (via its switch; "" = undeclared)."""
        return self._pod_of.get(self._switch_of.get(host, ""), "")

    def node_of(self, tier: str, host: str) -> str:
        """`host`'s enclosing node at `tier` — the host itself, its
        switch, or its pod ("" when that tier is undeclared)."""
        if tier == "host":
            return host
        if tier == "switch":
            return self.switch_of(host)
        if tier == "pod":
            return self.pod_of(host)
        raise ValueError(f"unknown tier {tier!r}")

    def tier_of(self, tier: str, job_id: str, rank: int) -> str:
        """One rank's enclosing node at `tier` ("" when undeclared)."""
        return self.node_of(tier, self.host_of(job_id, rank))

    def nodes(self, tier: str) -> tuple[str, ...]:
        """Every distinct node name at `tier`, sorted — the canonical
        axis of that tier.  Only nodes reachable from a declared job's
        hosts count (stale fabric entries never widen a kernel axis)."""
        return tuple(
            sorted(
                {
                    n
                    for h in self.hosts()
                    if (n := self.node_of(tier, h))
                }
            )
        )

    def hosts_under(self, tier: str, node: str) -> tuple[str, ...]:
        """Declared-job hosts whose `tier` node is `node`, sorted."""
        return tuple(
            h for h in self.hosts() if self.node_of(tier, h) == node
        )

    def jobs_under(self, tier: str, node: str) -> tuple[str, ...]:
        """Jobs with >= 1 rank under `node` at `tier`, sorted."""
        return tuple(
            sorted(
                j
                for j, hs in self._jobs.items()
                if any(self.node_of(tier, h) == node for h in hs)
            )
        )

    def ranks_under(self, tier: str, job_id: str, node: str) -> tuple[int, ...]:
        """Ranks of `job_id` whose `tier` node is `node`."""
        return tuple(
            r
            for r, h in enumerate(self._jobs.get(job_id, ()))
            if self.node_of(tier, h) == node
        )

    def __contains__(self, job_id: str) -> bool:
        return job_id in self._jobs

    def __len__(self) -> int:
        return len(self._jobs)
