"""The five examples of the port, each a module with a ``main``:

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

`hidden_rank_demo`, `whatif_demo`, `fleet_monitor`, `serve_demo` and
`quickstart`.  Each runs on CUDA unless ``--device cpu`` and raises
without a card; ``main(argv)`` prints what the reference example prints,
keeps its asserts, and returns a summary that holds the printed lines.
"""
