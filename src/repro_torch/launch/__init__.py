"""Command-line launchers: ``python -m repro_torch.launch.serve`` (the
filter service over a served backbone) and ``python -m
repro_torch.launch.watch`` (standing queries over a replayed stream).

Both run on the card; their ``main(argv=None, device="cuda")`` takes the
device as a keyword for in-process callers (tests on the CPU, the chip
smoke script), not as a command-line flag.
"""
