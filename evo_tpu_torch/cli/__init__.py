"""Command-line entry points: `python -m evo_tpu_torch.cli.score` and
`python -m evo_tpu_torch.cli.generate`."""
