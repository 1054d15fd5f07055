"""Runnable examples of the port, one module each:

    python -m repro_torch.examples.quickstart         # Session/Query API
    python -m repro_torch.examples.watch_demo         # standing queries
    python -m repro_torch.examples.serve_filter       # ModelOracle path
    python -m repro_torch.examples.service_demo       # concurrent service
    python -m repro_torch.examples.distributed_demo   # shards, lanes, log
    python -m repro_torch.examples.incremental_updates
    python -m repro_torch.examples.train_backbone     # training, restart

Each runs on the card; ``main(device="cpu")`` runs it on the CPU through
the kernels' plain versions (``train_backbone.main(argv, device="cpu")``).
Each asserts its contracts inline.
"""
