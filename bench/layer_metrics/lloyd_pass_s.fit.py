"""lloyd_pass_s.fit: the backend's Lloyd phase, wall seconds a pass (iterations + the
final assignment), from ``phases_["lloyd"]``."""
from bench.harness import readers


def read(run):
    return readers.lloyd_pass_s(run)
