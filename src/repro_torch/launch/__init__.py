"""Command-line launchers: ``python -m repro_torch.launch.serve`` (the
filter service over a served backbone), ``python -m
repro_torch.launch.watch`` (standing queries over a replayed stream),
``python -m repro_torch.launch.train`` (training) and
``python -m repro_torch.launch.dryrun`` (every arch x shape x mesh cell
as a partitioned program on a fake process group, no card needed).

The first three run on the card; their ``main(argv=None, device="cuda")``
takes the device as a keyword for in-process callers (tests on the CPU,
the chip smoke script), not as a command-line flag.  ``mesh`` builds
meshes over a process group, ``op_cost`` counts a step's FLOPs and bytes
and ``collectives`` the collectives a DTensor program emits.
"""
