"""The benchmark of evo_tpu_torch: `python benchmark/run.py --help`."""
