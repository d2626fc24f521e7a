"""Known-bad (when linted as a repro_torch.* library module): the library
importing the benchmark harness. Expected finding:
repro-torch-imports-benchmarks."""
from benchmarks.common import time_fn  # <-- finding


def timed(f, *args):
    return time_fn(f, *args)
