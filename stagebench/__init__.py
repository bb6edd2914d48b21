"""The benchmark of the PyTorch port (`repro_torch`): monitored training.

    python3 stagebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Layout, each piece found by name from ``BENCHMARK.json``:

- ``configs/<config>.json``: a model configuration as it is run (the
  port's sizes, its published source, what it assumes, its optimizer
  and its memory reckoning);
- ``traffic/<traffic>.json``: a traffic mix for the one generator in
  `traffic`;
- ``workloads/<cell>.json``: a cell's configuration, traffic, warm-up,
  checked steps, monitor window and the limits of its check;
- ``metrics/<metric>.py``: one reader per metric;
- `flops`: model FLOPs of a step, one module per family;
- `reference`: the plain f32 reference and the monitor's accounting in
  NumPy, which decide ``correct`` (`check`);
- `run`: one run; `calibrate`: the readings the limits are set from.

Nothing here imports JAX or the JAX package; the program is reached
only through `program`.
"""
