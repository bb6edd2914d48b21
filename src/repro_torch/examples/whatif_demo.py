"""What-if counterfactual demo: price a fix before making it.

    PYTHONPATH=src python -m repro_torch.examples.whatif_demo [--device cpu]

Injects a known fault into a simulated DDP job, runs the counterfactual
what-if engine (`repro_torch.core.whatif`) with the job's declared sync
profile, and checks the answer against the simulator's ground truth:

  1. a rank-attributable data fault: the top-1 intervention must localize
     the seeded (stage, rank) and price it at >= 90% of the injected
     delay;
  2. a slow collective (comm fault): every single-rank candidate must be
     priced ~0 and flagged — group-wide delay is not one rank's to fix;
  3. the kernel route (`repro_torch.kernels.frontier.whatif_matrix`, a
     float32 tensor on ``--device``: one launch of the CUDA what-if
     kernel on the card, its plain torch version on the CPU) agrees with
     the NumPy engine on the same window.

The port's counterpart of `examples/whatif_demo.py`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import make_sync_mask, whatif_matrix
from ..kernels.frontier import whatif_matrix as whatif_matrix_kernelroute
from ..sim import simulate
from ..sim.scenarios import attributable_recoverable, ddp_scenario, e3_fault
from ._common import Lines, parse


def main(argv=None) -> dict:
    args = parse("whatif_demo", __doc__, argv)
    out = Lines()
    # --- 1. rank-attributable fault: localize and price it -----------------
    sc = ddp_scenario(
        world_size=8, steps=20, seed=7, faults=(e3_fault("data", 5, 0.15),)
    )
    res = simulate(sc)
    mask = make_sync_mask(sc.stages, sc.sync_stages)
    wif = whatif_matrix(res.durations, sync_mask=mask)
    truth = attributable_recoverable(sc)
    (truth_key, truth_s), = truth.items()

    out("top-3 interventions (data fault, 150 ms on rank 5):")
    for iv in wif.top(3):
        tag = "feasible" if iv.feasible else "+".join(iv.flags)
        out(
            f"  fix ({sc.stages[iv.stage]}, rank {iv.rank}) "
            f"-> recover {iv.recoverable_s:.3f}s "
            f"({100 * iv.fraction:.1f}% of step time) [{tag}]"
        )
    top = wif.top(1)[0]
    assert (sc.stages[top.stage], top.rank) == truth_key, (top, truth_key)
    assert top.recoverable_s >= 0.9 * truth_s, (top.recoverable_s, truth_s)
    out(
        f"ground truth {truth_s:.3f}s at {truth_key} — "
        f"top-1 recovered {100 * top.recoverable_s / truth_s:.1f}%"
    )

    # --- 2. slow collective: marked group-wide, never pinned on a rank -----
    sc2 = ddp_scenario(
        world_size=8,
        steps=20,
        seed=7,
        faults=(e3_fault("backward_comm", 5, 0.15),),
    )
    res2 = simulate(sc2)
    wif2 = whatif_matrix(
        res2.durations, sync_mask=make_sync_mask(sc2.stages, sc2.sync_stages)
    )
    top2 = wif2.top(1)[0]
    injected = 0.15 * sc2.steps
    assert top2.recoverable_s < 0.1 * injected, top2
    out(
        f"\nslow collective: best single-rank candidate prices at "
        f"{top2.recoverable_s:.4f}s of {injected:.1f}s injected "
        f"(flags: {', '.join(top2.flags) or 'none'}) — "
        "routed to the fabric, not a rank"
    )

    # --- 3. kernel route agrees with the NumPy engine ----------------------
    sync_idx = tuple(
        i for i, s in enumerate(sc.stages) if s in sc.sync_stages
    )
    d = torch.as_tensor(res.durations, dtype=torch.float32, device=args.device)
    kp = whatif_matrix_kernelroute(d, sync_stages=sync_idx)
    matrix = kp.matrix.cpu().numpy()
    np.testing.assert_allclose(matrix, wif.matrix, rtol=1e-3, atol=2e-3)
    out("\nkernel route matches the NumPy engine — OK")
    return {"lines": out.lines, "matrix": matrix, "numpy_matrix": wif.matrix,
            "durations": res.durations, "sync_stages": sync_idx,
            "top": (sc.stages[top.stage], top.rank, top.recoverable_s),
            "truth": (truth_key, truth_s)}


if __name__ == "__main__":
    main()
