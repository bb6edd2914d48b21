"""Versioned trace schema, defensive loader, and synthetic generator.

A *trace* is the cluster-shaped description of a fleet over time: jobs
arrive, change rank sets, depart; faults with known families switch on
and off.  The format is JSONL — one JSON object per line — because that
is what real cluster traces (Alibaba GPU traces, Microsoft Philly logs)
reduce to after normalization, and because a line-oriented format
degrades *per row*: a corrupt or truncated line costs exactly that line,
counted in `TraceStats`, never an exception mid-replay.

Row kinds (all rows carry ``"v": 1`` and ``"kind"``):

  meta     trace-level header: name, ``window_steps`` (steps per
           evidence window == per replay tick), ``ticks`` (trace length)
  arrive   a job joins: ``tick``, ``job_id``, ``world_size``,
           ``stages`` (the job's stage vocabulary — jobs may disagree),
           ``sync_stages``, ``tasks`` (Alibaba task taxonomy: a list of
           ``{"role": ps|worker|chief|evaluator, "ranks": [...]}``),
           ``hosts`` (optional per-rank placement), ``switches`` /
           ``pods`` (optional per-rank fabric tiers above each host —
           switches require hosts, pods require switches, all aligned
           per rank, mirroring the SFP2-v3 wire layout), ``seed``
  resize   the job's rank set changes mid-run: ``tick``, ``job_id``,
           ``world_size``, optional new ``tasks``/``hosts``/
           ``switches``/``pods`` — the fleet tier must treat this as a
           schema break (stream restart)
  depart   the job leaves: ``tick``, ``job_id`` — it simply stops
           reporting, exercising the registry's eviction path
  fault    injected ground truth: ``tick``, ``job_id``, ``family``
           (one of `FAULT_FAMILIES`), ``rank``, ``delay_ms``,
           ``until_tick`` (exclusive; -1 = until the job leaves)

Because faults are declared with a *family* from the simulator's fault
taxonomy (`sim.scenarios`), every replayed window carries injected
ground truth: the replay engine reconstructs the per-window attributable
(stage, rank) candidates exactly as `scenarios.attributable_recoverable`
does, and scores the fleet's routing answer against them.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable

import numpy as np

from ..core.contract import SEGMENTED_STAGES
from ..sim.scenarios import DDP_BASE, DDP_SYNC, FSDP_SYNC, ZERO1_SYNC

__all__ = [
    "FAULT_FAMILIES",
    "SCORED_FAMILIES",
    "TRACE_VERSION",
    "Trace",
    "TraceEvent",
    "TraceStats",
    "TraceTask",
    "family_stage",
    "generate_trace",
    "load_trace",
    "parse_trace",
]

TRACE_VERSION = 1

#: fault family -> the stage where the host observes the injected delay.
#: Families reuse the simulator's taxonomy: the E3 hidden-rank families
#: ("data", "forward_host") plus the temporal regime families
#: ("step", "intermittent", "drift", "blip") — all seeded at
#: ``data.next_wait`` — and the group-ambiguous control
#: ("backward_comm": a slow collective; no single-rank fix recovers it,
#: so replay validation must never expect it in the routing answer).
_FAMILY_STAGES = {
    "data": "data.next_wait",
    "forward_host": "model.fwd_loss_cpu_wall",
    "backward_comm": "model.backward_cpu_wall",
    "step": "data.next_wait",
    "intermittent": "data.next_wait",
    "drift": "data.next_wait",
    "blip": "data.next_wait",
}
FAULT_FAMILIES = tuple(_FAMILY_STAGES)
#: families whose injected delay is rank-attributable from coarse stage
#: durations (host-mode at a non-sync stage); replay scores routing
#: accuracy on these.  "backward_comm" is deliberately absent.
SCORED_FAMILIES = tuple(f for f in FAULT_FAMILIES if f != "backward_comm")

#: Alibaba-trace task taxonomy (Snippet 1): the role vocabulary a trace
#: may assign to a job's ranks.
TASK_ROLES = ("ps", "worker", "chief", "evaluator")

#: per-stage base means (seconds) for every stage any template emits;
#: superset of the simulator's DDP profile.
STAGE_MEANS = dict(
    DDP_BASE,
    **{
        "ps.push_wait": 0.010,      # parameter-server gradient push
        "eval.metrics_wall": 0.030,  # evaluator metric pass
    },
)

#: stage vocabularies per job template — deliberately heterogeneous:
#: the fleet ingest must carry jobs that disagree on S through one pipe.
WORKER_STAGES = tuple(SEGMENTED_STAGES)
PS_STAGES = tuple(SEGMENTED_STAGES) + ("ps.push_wait",)
EVAL_STAGES = ("data.next_wait", "model.fwd_loss_cpu_wall", "eval.metrics_wall")


def family_stage(family: str) -> str:
    """Stage where `family` is host-observed (KeyError on unknown)."""
    return _FAMILY_STAGES[family]


@dataclasses.dataclass(frozen=True)
class TraceTask:
    """One task group of a job: a role and the ranks it owns."""

    role: str
    ranks: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One validated trace row (field relevance depends on `kind`)."""

    kind: str
    tick: int
    job_id: str = ""
    world_size: int = 0
    stages: tuple[str, ...] = ()
    sync_stages: tuple[str, ...] = ()
    tasks: tuple[TraceTask, ...] = ()
    hosts: tuple[str, ...] = ()
    #: per-rank fabric placement above `hosts` (optional, aligned)
    switches: tuple[str, ...] = ()
    pods: tuple[str, ...] = ()
    seed: int = 0
    family: str = ""
    rank: int = -1
    delay_ms: float = 0.0
    until_tick: int = -1

    def roles(self) -> tuple[str, ...]:
        """Per-rank role tuple derived from `tasks` (() = homogeneous)."""
        if not self.tasks:
            return ()
        roles = ["worker"] * self.world_size
        for t in self.tasks:
            for r in t.ranks:
                roles[r] = t.role
        return tuple(roles)


@dataclasses.dataclass
class TraceStats:
    """Loader counters: data loss is bounded per row and observable."""

    rows: int = 0
    accepted: int = 0
    skipped: int = 0
    skip_reasons: dict = dataclasses.field(default_factory=dict)

    def skip(self, reason: str) -> None:
        self.skipped += 1
        self.skip_reasons[reason] = self.skip_reasons.get(reason, 0) + 1


@dataclasses.dataclass(frozen=True)
class Trace:
    """A loaded trace: header + time-ordered events + loader stats."""

    name: str
    window_steps: int
    ticks: int
    events: tuple[TraceEvent, ...]
    stats: TraceStats

    def events_at(self, tick: int) -> list[TraceEvent]:
        return [e for e in self.events if e.tick == tick]


# ---------------------------------------------------------------------------
# loader — every row is validated independently; malformed rows are
# counted skips, never exceptions (mirrors the wire ingest contract).
# ---------------------------------------------------------------------------


def _as_str_tuple(v) -> tuple[str, ...]:
    if not isinstance(v, list) or not all(isinstance(s, str) for s in v):
        raise ValueError("expected a list of strings")
    return tuple(v)


def _as_int(v, lo: int, hi: int) -> int:
    if not isinstance(v, int) or isinstance(v, bool) or not lo <= v <= hi:
        raise ValueError(f"expected an int in [{lo}, {hi}]")
    return v


def _parse_placement(row: dict, ws: int) -> dict:
    """Validate the optional placement sections of an arrive/resize row
    (hosts, switches, pods): per-rank, aligned, tiered — switches need
    hosts, pods need switches, matching the SFP2-v3 wire contract."""
    hosts = _as_str_tuple(row.get("hosts", []))
    if hosts and len(hosts) != ws:
        raise ValueError("bad_hosts")
    switches = _as_str_tuple(row.get("switches", []))
    if switches and (not hosts or len(switches) != ws):
        raise ValueError("bad_switches")
    pods = _as_str_tuple(row.get("pods", []))
    if pods and (not switches or len(pods) != ws):
        raise ValueError("bad_pods")
    return {"hosts": hosts, "switches": switches, "pods": pods}


def _parse_tasks(raw, world_size: int) -> tuple[TraceTask, ...]:
    if raw is None:
        return ()
    if not isinstance(raw, list):
        raise ValueError("tasks must be a list")
    seen: set[int] = set()
    out = []
    for t in raw:
        if not isinstance(t, dict) or not isinstance(t.get("role"), str):
            raise ValueError("task must be {role, ranks}")
        if t["role"] not in TASK_ROLES:
            raise ValueError(f"unknown task role {t['role']!r}")
        ranks = t.get("ranks")
        if not isinstance(ranks, list) or not ranks:
            raise ValueError("task ranks must be a non-empty list")
        rk = tuple(_as_int(r, 0, world_size - 1) for r in ranks)
        if seen & set(rk):
            raise ValueError("task rank sets overlap")
        seen |= set(rk)
        out.append(TraceTask(role=t["role"], ranks=rk))
    return tuple(out)


def _parse_row(row: dict) -> TraceEvent:
    """Validate one parsed JSON row into a TraceEvent (ValueError on any
    malformation — the caller counts and drops)."""
    if row.get("v") != TRACE_VERSION:
        raise ValueError("bad_version")
    kind = row.get("kind")
    if kind == "meta":
        return TraceEvent(
            kind="meta",
            tick=-1,
            job_id=str(row.get("name", "")),
            world_size=_as_int(row.get("window_steps"), 1, 10_000),
            seed=_as_int(row.get("ticks"), 1, 10**9),
        )
    tick = _as_int(row.get("tick"), 0, 10**9)
    job_id = row.get("job_id")
    if not isinstance(job_id, str) or not job_id:
        raise ValueError("bad_job_id")
    if kind == "arrive":
        ws = _as_int(row.get("world_size"), 1, 4096)
        stages = _as_str_tuple(row.get("stages"))
        if not stages:
            raise ValueError("empty_stages")
        sync = _as_str_tuple(row.get("sync_stages", []))
        if not set(sync) <= set(stages):
            raise ValueError("sync_not_in_stages")
        return TraceEvent(
            kind="arrive", tick=tick, job_id=job_id, world_size=ws,
            stages=stages, sync_stages=sync,
            tasks=_parse_tasks(row.get("tasks"), ws),
            seed=_as_int(row.get("seed", 0), 0, 2**31 - 1),
            **_parse_placement(row, ws),
        )
    if kind == "resize":
        ws = _as_int(row.get("world_size"), 1, 4096)
        return TraceEvent(
            kind="resize", tick=tick, job_id=job_id, world_size=ws,
            tasks=_parse_tasks(row.get("tasks"), ws),
            **_parse_placement(row, ws),
        )
    if kind == "depart":
        return TraceEvent(kind="depart", tick=tick, job_id=job_id)
    if kind == "fault":
        family = row.get("family")
        if family not in FAULT_FAMILIES:
            raise ValueError("bad_family")
        delay = row.get("delay_ms")
        if not isinstance(delay, (int, float)) or isinstance(delay, bool) \
                or not 0.0 < float(delay) <= 1e6:
            raise ValueError("bad_delay")
        until = row.get("until_tick", -1)
        if until != -1:
            until = _as_int(until, tick + 1, 10**9)
        return TraceEvent(
            kind="fault", tick=tick, job_id=job_id, family=family,
            rank=_as_int(row.get("rank"), 0, 4095),
            delay_ms=float(delay), until_tick=until,
        )
    raise ValueError("bad_kind")


def parse_trace(text: str, *, name: str = "") -> Trace:
    """Parse JSONL trace content.  NEVER raises on malformed content:
    every bad line (truncated, corrupt JSON, wrong types, unknown kind)
    is a counted skip in the returned trace's `stats`."""
    stats = TraceStats()
    events: list[TraceEvent] = []
    meta: TraceEvent | None = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stats.rows += 1
        try:
            row = json.loads(line)
        except Exception:
            stats.skip("bad_json")
            continue
        if not isinstance(row, dict):
            stats.skip("bad_row")
            continue
        try:
            ev = _parse_row(row)
        except ValueError as e:
            stats.skip(str(e) or "bad_fields")
            continue
        except Exception:
            stats.skip("bad_fields")
            continue
        stats.accepted += 1
        if ev.kind == "meta":
            if meta is None:
                meta = ev
            else:
                stats.accepted -= 1
                stats.skip("duplicate_meta")
            continue
        events.append(ev)
    # stable sort: events on the same tick keep file order — replay
    # semantics must not depend on how a writer interleaved one tick.
    events.sort(key=lambda e: e.tick)
    if meta is not None:
        name, window_steps, ticks = meta.job_id, meta.world_size, meta.seed
    else:
        stats.skip("missing_meta")
        window_steps = 8
        ticks = 1 + max((e.tick for e in events), default=0)
    return Trace(
        name=name or "unnamed",
        window_steps=window_steps,
        ticks=ticks,
        events=tuple(events),
        stats=stats,
    )


def load_trace(path: str | os.PathLike) -> Trace:
    """Load a JSONL trace file (defensive per row; see `parse_trace`)."""
    with open(path, "rb") as f:
        raw = f.read()
    # a truncated file may end mid-UTF-8-sequence: decode defensively,
    # the affected line then fails JSON parsing and is counted.
    return parse_trace(
        raw.decode("utf-8", errors="replace"),
        name=os.path.splitext(os.path.basename(str(path)))[0],
    )


# ---------------------------------------------------------------------------
# deterministic synthetic generator
# ---------------------------------------------------------------------------


def _job_template(j: int) -> str:
    """Template cycle: mostly plain workers, with parameter-server and
    chief/evaluator jobs mixed in (the Alibaba role taxonomy)."""
    return ("worker", "worker", "ps", "worker", "eval")[j % 5]


_SYNC_PROFILES = (DDP_SYNC, FSDP_SYNC, ZERO1_SYNC)


def _job_spec(j: int, world_size: int) -> dict:
    """Deterministic per-job shape: stage vocabulary, sync profile,
    task/role assignment, world size."""
    template = _job_template(j)
    if template == "eval":
        return {
            "template": template,
            "world_size": 2,
            "stages": EVAL_STAGES,
            "sync": (),
            "tasks": [
                {"role": "chief", "ranks": [0]},
                {"role": "evaluator", "ranks": [1]},
            ],
        }
    if template == "ps":
        ws = max(4, world_size)
        return {
            "template": template,
            "world_size": ws,
            "stages": PS_STAGES,
            "sync": DDP_SYNC,
            "tasks": [
                {"role": "ps", "ranks": [0, 1]},
                {"role": "worker", "ranks": list(range(2, ws))},
            ],
        }
    sync = _SYNC_PROFILES[j % len(_SYNC_PROFILES)]
    return {
        "template": template,
        "world_size": world_size,
        "stages": WORKER_STAGES,
        "sync": sync,
        "tasks": [
            {"role": "chief", "ranks": [0]},
            {"role": "worker", "ranks": list(range(1, world_size))},
        ],
    }


def _fault_family(i: int, spec: dict) -> str:
    """Family rotation for the i-th faulted job, constrained to families
    whose seeded stage exists in the job's vocabulary and is observable
    there (forward_host is sync-ambiguous under FSDP — swap for data)."""
    rotation = ("data", "step", "intermittent", "forward_host", "drift",
                "backward_comm")
    family = rotation[i % len(rotation)]
    if family_stage(family) not in spec["stages"]:
        return "data"
    if family_stage(family) in spec["sync"] and family != "backward_comm":
        return "data"
    return family


def _fault_rank(j: int, spec: dict) -> int:
    """Seed-derived faulted rank, always a worker/evaluator task rank
    (ps ranks sync in their own tiny group; pricing a fault there from
    coarse durations would be scoring the imputation, not the fault)."""
    pool = [
        r for t in spec["tasks"] for r in t["ranks"]
        if t["role"] in ("worker", "evaluator")
    ]
    return pool[(j * 7 + 3) % len(pool)]


def generate_trace(
    *,
    jobs: int = 12,
    ticks: int = 16,
    window_steps: int = 8,
    world_size: int = 8,
    seed: int = 0,
    delay_ms: float = 150.0,
    fault_every: int = 3,
    elastic: bool = True,
    hosts: bool = True,
    fabric: bool = False,
    shared_switch: bool = False,
    name: str | None = None,
) -> str:
    """Deterministic synthetic trace (JSONL text), same seed -> same bytes.

    The generated fleet is heterogeneous on every axis the homogeneous
    sim scenarios cannot express: stage vocabularies differ per job
    (worker / parameter-server / evaluator templates), sync profiles
    rotate DDP/FSDP/ZeRO-1, task roles follow the Alibaba taxonomy,
    jobs arrive staggered, some depart mid-trace (eviction), one
    re-arrives under the same job id with a different rank set, and
    some resize mid-run (schema break, regime-stream restart).

    Faults come from the simulator's families with the delay and active
    interval recorded in the trace — the injected ground truth replay
    validation scores against.  Fault intervals are scheduled on two
    "lanes" so at most two rank-attributable faults are live at any
    tick: the fleet's top-2 routing answer can and must contain every
    scored fault.

    `fabric` adds per-rank ``switches``/``pods`` placement to every
    arrive/resize row (private fabric per job).  `shared_switch`
    (implies `fabric`) turns the trace into a tier-attribution row: the
    faulted jobs' faulted ranks are re-homed onto DISTINCT private
    hosts that all sit under the shared switch ``fab-sw0`` (pod
    ``fab-pod0``), their family is pinned to ``data``, and their fault
    intervals all run concurrently from tick 1 — the ground truth is
    ONE switch-tier fleet incident on ``fab-sw0``, never a host
    incident (no host is shared) and never a pod one (the evidence
    needs only the switch).  Note the concurrent faults break the
    two-lane top-2 containment guarantee by design: a shared-switch
    trace scores tier attribution, not top-2 routing.
    """
    if shared_switch:
        fabric = True
    if fabric:
        hosts = True
    rng = np.random.default_rng(seed)
    rows: list[dict] = [{
        "v": TRACE_VERSION, "kind": "meta",
        "name": name or f"synth-{seed}",
        "window_steps": window_steps, "ticks": ticks,
    }]
    events: list[tuple[int, int, dict]] = []   # (tick, order, row)
    order = 0

    def add(tick: int, row: dict) -> None:
        nonlocal order
        row = {"v": TRACE_VERSION, **row, "tick": tick}
        events.append((tick, order, row))
        order += 1

    faulted = [
        j for j in range(jobs) if fault_every > 0 and j % fault_every == 0
    ]
    # two-lane fault schedule: lane l runs its i-th fault in
    # [base + i*stride, base + i*stride + flen), so each lane holds at
    # most one live fault and the fleet at most two.
    nf_per_lane = max(1, (len(faulted) + 1) // 2)
    span = max(4, ticks - 3)
    stride = max(4, span // nf_per_lane)
    flen = max(3, stride - 1)

    for j in range(jobs):
        spec = _job_spec(j, world_size)
        ws = spec["world_size"]
        # faulted jobs arrive at tick 0: a staggered arrival would push
        # their fault interval past its lane slot, letting three scored
        # faults go live at once (the top-2 containment guarantee needs
        # <= 2).  Elastic churn still comes from the unfaulted jobs.
        arrive = (
            int(rng.integers(0, max(1, ticks // 4)))
            if elastic and j not in faulted else 0
        )
        depart = ticks
        if elastic and j % 5 == 4 and j not in faulted:
            depart = max(arrive + 3, (2 * ticks) // 3)
        host_list = (
            [f"t{j}h{r // 2}" for r in range(ws)] if hosts else []
        )
        switch_list = (
            [f"t{j}sw{r // 4}" for r in range(ws)] if fabric else []
        )
        pod_list = [f"t{j}pod0" for _ in range(ws)] if fabric else []
        if shared_switch and j in faulted:
            # own host, shared switch: the tier-attribution placement
            fr = _fault_rank(j, spec)
            host_list[fr] = f"fabh{j}"
            switch_list[fr] = "fab-sw0"
            pod_list[fr] = "fab-pod0"
        add(arrive, {
            "kind": "arrive", "job_id": f"job-{j:03d}", "world_size": ws,
            "stages": list(spec["stages"]),
            "sync_stages": list(spec["sync"]),
            "tasks": spec["tasks"], "hosts": host_list,
            **({"switches": switch_list, "pods": pod_list} if fabric else {}),
            "seed": seed * 10_000 + j,
        })
        if depart < ticks:
            add(depart, {"kind": "depart", "job_id": f"job-{j:03d}"})
        if j in faulted:
            i = faulted.index(j)
            if shared_switch:
                # concurrent steady data stalls: the switch-tier common
                # cause must co-activate across every member job
                add(1, {
                    "kind": "fault", "job_id": f"job-{j:03d}",
                    "family": "data", "rank": _fault_rank(j, spec),
                    "delay_ms": float(delay_ms), "until_tick": -1,
                })
                continue
            lane, slot = i % 2, i // 2
            f0 = min(max(arrive + 1, 1 + slot * stride + lane), ticks - 2)
            f1 = min(f0 + flen, depart, ticks)
            if f1 > f0:
                add(f0, {
                    "kind": "fault", "job_id": f"job-{j:03d}",
                    "family": _fault_family(i, spec),
                    "rank": _fault_rank(j, spec),
                    "delay_ms": float(delay_ms), "until_tick": f1,
                })

    if elastic and jobs >= 5:
        # one departed job re-arrives under the SAME id with a different
        # rank set (elastic restart: the registry must restart cleanly),
        # and one long-lived job resizes in place mid-run.
        gone = [j for j in range(jobs) if j % 5 == 4 and j not in faulted]
        if gone:
            j = gone[0]
            spec = _job_spec(j, world_size)
            back = min((2 * ticks) // 3 + 3, ticks - 2)
            ws2 = max(2, spec["world_size"] // 2)
            add(back, {
                "kind": "arrive", "job_id": f"job-{j:03d}",
                "world_size": ws2,
                "stages": list(spec["stages"]),
                "sync_stages": list(spec["sync"]),
                "tasks": [{"role": "worker", "ranks": list(range(ws2))}],
                "hosts": [f"t{j}r{r // 2}" for r in range(ws2)] if hosts else [],
                "seed": seed * 10_000 + j + 500,
            })
        resizable = [
            j for j in range(jobs)
            if j not in faulted and j % 5 not in (2, 4) and jobs > 1
        ]
        if resizable:
            j = resizable[-1]
            spec = _job_spec(j, world_size)
            ws2 = max(2, spec["world_size"] // 2)
            add(max(1, ticks // 2), {
                "kind": "resize", "job_id": f"job-{j:03d}",
                "world_size": ws2,
                "tasks": [{"role": "worker", "ranks": list(range(ws2))}],
                "hosts": [f"t{j}n{r // 2}" for r in range(ws2)] if hosts else [],
            })

    events.sort(key=lambda t: (t[0], t[1]))
    rows.extend(row for _, _, row in events)
    return "\n".join(json.dumps(r, separators=(",", ":")) for r in rows) + "\n"
