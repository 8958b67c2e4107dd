"""kernel_roofline_pct.predict: the predict calls' counted work (bench/work) at
the chip's peaks, over all device kernel time in the profiler's trace."""
from bench.harness import readers


def read(run):
    return readers.kernel_roofline_pct(run, "predict")
