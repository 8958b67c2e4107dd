"""Paper dataset configs (Section 9, Table 1) with synthetic stand-ins.

A copy of the JAX package's table (pure data). The real datasets are not
shipped: each entry records the real dataset's (n, d, k) and the kernel the
paper used, plus the synthetic generator parameters that mirror its scale
for the benchmarks (see repro_torch/data/synthetic.py).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperDataset:
    name: str
    n: int
    d: int
    k: int
    kernel: str          # "rbf" | "tanh" | "poly" (self-tuned gamma for rbf)
    kernel_params: tuple = ()
    bench_n: int = 0     # rows actually generated in benchmarks (0 -> n)
    separation: float = 3.0  # synthetic cluster separation (controls difficulty)


PAPER_DATASETS = {
    "usps": PaperDataset("usps", 9_298, 256, 10, "tanh", (0.0045, 0.11)),
    "pie": PaperDataset("pie", 11_554, 4_096, 68, "rbf", (), bench_n=11_554, separation=2.0),
    "mnist": PaperDataset("mnist", 70_000, 784, 10, "poly", (5, 1.0), bench_n=20_000),
    "rcv1": PaperDataset("rcv1", 193_844, 47_236, 103, "rbf", (), bench_n=20_000, separation=2.0),
    "covtype": PaperDataset("covtype", 581_012, 54, 7, "rbf", (), bench_n=50_000, separation=1.5),
    "imagenet": PaperDataset("imagenet", 1_262_102, 900, 164, "rbf", (), bench_n=50_000, separation=1.5),
    "imagenet-50k": PaperDataset("imagenet-50k", 50_000, 900, 164, "rbf", (), separation=1.5),
}
