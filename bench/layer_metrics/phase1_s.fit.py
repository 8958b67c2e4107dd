"""phase1_s.fit: phase 1 of the estimator (host view, reservoir sample, embedding fit,
k-means++ seeding), wall seconds a fit, from the ``phase.*`` spans' ``phases_``."""
from bench.harness import readers


def read(run):
    return readers.phase1_s(run)
