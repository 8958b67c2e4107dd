"""kernel_roofline_pct.fit: the fits' counted work (bench/work) at the chip's
peaks, over all device kernel time in the profiler's trace of the traced fits."""
from bench.harness import readers


def read(run):
    return readers.kernel_roofline_pct(run, "fit")
