"""idle_pct.predict: the share of the traced predict calls' window with no
kernel, copy or set on the card, from the profiler's trace."""
from bench.harness import readers


def read(run):
    return readers.idle_pct(run, "predict")
