"""Fleet-scale monitoring demo: the repro_torch.fleet subsystem end-to-end.

    PYTHONPATH=src python -m repro_torch.examples.fleet_monitor [--device cpu]

Drives the streaming fleet pipeline over simulated jobs with heterogeneous
faults:

  1. a fleet of jobs (mixed DDP/FSDP/ZeRO-1 sync profiles) streams evidence
     packets over the int8 wire format into a FleetService
     (`repro_torch.launch.serve_fleet` on ``--device``: the fused tick
     kernel on the card); injected E3 faults must surface in the top-K
     profiler routing with the seeded stage and rank, the top entry's
     counterfactual recoverable seconds must cover >= 90% of the known
     injected delay, and the always-on fault must classify `persistent`
     with full persistence weight;
  2. the incremental StreamingFrontier state matches the batch pass
     bit-for-bit while never holding a [N, R, S] window;
  3. failure drill: one job dies (evicted), one job's gather degrades
     (telemetry_limited -> excluded from routing, dead ranks recorded);
  4. the [J, N, R, S] fleet frontier route re-accounts every job in one
     launch of the CUDA frontier kernel (`fleet_frontier_window`) and
     agrees with the per-job path (`fleet_frontier_loop`, J launches).

The port's counterpart of `examples/fleet_monitor.py`: the same argv,
asserts and printed lines.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import StreamingFrontier, frontier_accounting
from ..kernels.frontier import fleet_frontier_loop, fleet_frontier_window
from ..launch import serve_fleet
from ..sim import simulate
from ..sim.scenarios import hidden_rank_scenario
from ._common import Lines, parse

#: the fleet service's argv (before ``--device``)
SERVE_ARGV = ["--jobs", "9", "--ranks", "8", "--window", "20", "--rounds", "3",
              "--top-k", "4", "--delay-ms", "250"]


def fleet_window() -> np.ndarray:
    """Part 3's input: four 256-rank jobs with a data fault, [4, 10, 256, 6]."""
    return np.stack([
        simulate(hidden_rank_scenario("data", world_size=256, steps=10,
                                      seed=s, delay_ms=200.0)).durations
        for s in range(4)
    ]).astype(np.float32)


def main(argv=None) -> dict:
    args = parse("fleet_monitor", __doc__, argv)
    out = Lines()
    # --- 1. heterogeneous fleet through the service ------------------------
    fargs = serve_fleet.make_argparser().parse_args(
        SERVE_ARGV + ["--device", args.device])
    summary = serve_fleet.run(fargs)
    out("fleet service summary:")
    out(f"  jobs={summary['snapshot']['jobs']} "
        f"degraded={summary['snapshot']['degraded_jobs']} "
        f"evicted={summary['snapshot']['evicted_total']} "
        f"wire bytes/packet={summary['wire_bytes_per_packet']}")
    for r in summary["routing"]:
        out(f"  route -> {r['job']}: {r['stage']} rank {r['rank']} "
            f"recoverable {r['recoverable_s']}s "
            f"regime={r['regime'] or '?'} persistence={r['persistence']} "
            f"onset={r['onset_step']}")
    assert summary["snapshot"]["evicted_total"] >= 1, "dead job must evict"
    assert summary["snapshot"]["degraded_jobs"] >= 1, "bad gather must degrade"
    routed_jobs = {r["job"] for r in summary["routing"]}
    faulted = {f"job-{j:03d}" for j in range(fargs.jobs)
               if j % fargs.fault_every == 0 and j not in (1, 2)}
    hits = {j for j in routed_jobs if j[:7] in faulted}
    assert hits, f"faulted jobs must appear in routing, got {routed_jobs}"
    # job-000 carries the rank-attributable data fault (rank 3, 250 ms x
    # 20-step windows => 5 s injected per window); the counterfactual
    # routing score must localize it and price it at >= 90%.
    top = summary["routing"][0]
    injected = fargs.delay_ms / 1e3 * fargs.window
    assert top["job"].startswith("job-000"), top
    assert top["stage"] == "data.next_wait" and top["rank"] == 3, top
    assert top["recoverable_s"] >= 0.9 * injected, (top, injected)
    # the fault never heals, so the regime engine must call it persistent
    # (live since onset) and keep its full routing weight
    assert top["regime"] == "persistent" and top["persistence"] == 1.0, top
    assert top["onset_step"] == 0, top

    # --- 2. streaming state == batch pass, bit-for-bit ----------------------
    sc = hidden_rank_scenario("data", world_size=64, steps=40, seed=5,
                              delay_ms=180.0)
    res = simulate(sc)
    sf = StreamingFrontier(64, len(sc.stages), capacity=40)
    for t in range(40):
        sf.push(res.durations[t])
    ref = frontier_accounting(res.durations)
    st = sf.state()
    assert np.array_equal(st.frontier, ref.frontier)
    assert np.array_equal(st.advances, ref.advances)
    assert np.array_equal(st.leader, ref.leader)
    top = int(np.argmax(st.shares()))
    out(f"\nstreaming engine: 40 steps folded, top stage "
        f"{sc.stages[top]} (seeded {sc.faults[0].stage}) — bit-exact")
    assert top == res.seeded_stage_index()

    # --- 3. fleet frontier kernel: one launch for the whole fleet ----------
    fleet = torch.as_tensor(fleet_window(), device=args.device)  # [4, 10, 256, 6]
    batched = fleet_frontier_window(fleet)
    looped = fleet_frontier_loop(fleet)
    shares = batched.shares.cpu().numpy()
    np.testing.assert_allclose(shares, looped.shares.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    tops = np.argmax(shares, axis=1)
    out(f"fleet kernel: 4 jobs x 256 ranks in one dispatch, "
        f"top stages {[sc.stages[t] for t in tops]}")
    assert (tops == 0).all(), "every job seeded a data fault"

    out("\nOK: fleet service + streaming engine + fused fleet kernel")
    return {"lines": out.lines, "summary": summary, "shares": shares,
            "loop_shares": looped.shares.cpu().numpy()}


if __name__ == "__main__":
    main()
