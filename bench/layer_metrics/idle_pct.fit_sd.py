"""idle_pct.fit_sd: the share of the traced SD fits' window with no kernel,
copy or set on the card, from the profiler's trace."""
from bench.harness import readers


def read(run):
    return readers.idle_pct(run, "fit_sd")
