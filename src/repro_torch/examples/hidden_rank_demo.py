"""Hidden-rank fault routing demo — the paper's Figure 1 scenario, live.

    PYTHONPATH=src python -m repro_torch.examples.hidden_rank_demo [--device cpu]

Simulates an 8-rank DDP cluster where ONE rank (hidden from the diagnosis)
suffers a 120 ms data-pipeline tail.  Synchronization displaces the delay:
the waiting ranks observe it as backward time, so per-stage max/average
misroute — the frontier charges it once, to the data boundary, and the
labeler routes the investigator to (stage=data, rank=straggler), with the
failure-safe gather and evidence packet in the loop.

The port's counterpart of `examples/hidden_rank_demo.py`: the same NumPy
code path (no device work), the same printed lines.  Like every entry
point of the port it asks for ``--device`` (default cuda, raises without
a card).
"""
from __future__ import annotations

import numpy as np

from ..core import WindowAggregator, stage_scores
from ..distributed.policy import MonitorPolicy
from ..sim import simulate
from ..sim.scenarios import hidden_rank_scenario
from ..telemetry.gather import InProcTransport, TelemetryGather
from ..telemetry.packets import encode_packet, from_diagnosis
from ._common import Lines, parse


def main(argv=None) -> dict:
    parse("hidden_rank_demo", __doc__, argv)
    out = Lines()
    hidden_rank_seed = 7
    sc = hidden_rank_scenario("data", seed=hidden_rank_seed, delay_ms=120.0)
    res = simulate(sc)
    injected_rank = sc.faults[0].rank
    out(f"(secret: fault injected into rank {injected_rank}, stage data.next_wait)\n")

    # --- each rank reports only its own [N, S] vector; rank 0 gathers ----
    transport = InProcTransport(sc.world_size)
    for r in range(sc.world_size):
        TelemetryGather(transport, r).gather_window(res.durations[:, r, :])
    gathered = TelemetryGather(transport, 0).gather_window(res.durations[:, 0, :])
    assert gathered.ok

    # --- window aggregation + deterministic labeling ---------------------
    agg = WindowAggregator(sc.schema(), window_steps=res.durations.shape[0])
    report = None
    for t in range(gathered.window.shape[0]):
        report = agg.add_step(gathered.window[t], gathered.window[t].sum(-1)) or report
    diag = report.diagnosis

    out("what naive dashboards say:")
    for method in ("per_stage_max", "per_stage_average", "slowest_rank_breakdown"):
        scores = stage_scores(res.durations, method)
        top = sc.stages[int(np.argmax(scores))]
        out(f"  {method:24s} -> {top}")
    out("\nwhat StageFrontier says:")
    out(f"  routing candidates : {diag.routing_stages}")
    out("  frontier shares    : "
        + " ".join(f"{s}={v:.2f}" for s, v in zip(sc.stages, diag.shares) if v > 0.02))
    out(f"  straggler rank     : {diag.leader.leader_rank} "
        f"(lead share {diag.leader.leader_share:.0%})")
    out(f"  labels             : {diag.labels}")

    pkt = from_diagnosis(diag, sc.stages, report.steps, sc.world_size, 0)
    out(f"  evidence packet    : {len(encode_packet(pkt))} bytes")

    actions = MonitorPolicy(leader_persistence=1).on_report(report)
    for a in actions:
        out(f"  policy action      : {a.kind} ({a.reason})")

    assert diag.routing_stages[0] == "data.next_wait"
    assert diag.leader.leader_rank == injected_rank
    out("\nOK: routed to the injected stage and rank from coarse stage vectors only")
    return {"lines": out.lines, "routing": list(diag.routing_stages),
            "leader_rank": diag.leader.leader_rank, "injected_rank": injected_rank}


if __name__ == "__main__":
    main()
