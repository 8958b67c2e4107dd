"""k-means++ seeding of a pool in one launch: a hand-written CUDA kernel.

Replaces no TPU kernel: it takes the host's per-draw ``torch.multinomial``
(a copy of the weights and a wait for the card a draw) off the port's
seeding. The source is ``csrc/kmeanspp_seed.cu``; its header holds the rule,
what bounds it on an H100 (latency: k - 1 dependent draws) and its design
(one thread-block cluster with the pool resident in its shared memory).

``kmeanspp_seed`` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it computes the same function with the plain
version, ``ref.kmeanspp_seed_ref``. ``cluster_size`` is 0 for a pool whose
rows no cluster's shared memory holds; ``core/lloyd.py::kmeanspp_init``
routes such a pool to the plain version on the card. ``launches`` counts
kernel launches, each k - 1 picks; traced, a call on a card is a
``launch.kmeanspp_seed`` span.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import kmeanspp_seed_ref

#: Kernel launches so far (CUDA tensors only).
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _configure(lib: ctypes.CDLL) -> None:
    lib.kmeanspp_seed_f32.argtypes = [_P] * 5 + [_I] * 6 + [_P]
    lib.kmeanspp_seed_f32.restype = ctypes.c_int
    lib.kmeanspp_seed_cluster.argtypes = [_I, _I]
    lib.kmeanspp_seed_cluster.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return build.configured("kmeanspp_seed", _configure)


_CLUSTER: dict[tuple[int, int], int] = {}


def cluster_size(n: int, m: int) -> int:
    """CTAs of the cluster that holds an (n, m) f32 pool in its shared
    memory (8, or 16 where 8 do not hold it), or 0 where none does."""
    size = _CLUSTER.get((n, m))
    if size is None:
        size = int(_lib().kmeanspp_seed_cluster(n, m))
        if size < 0:
            build.check(-size, "kmeanspp_seed cluster")
        _CLUSTER[(n, m)] = size
    return size


@build.launch_span("kmeanspp_seed")
def kmeanspp_seed(
    Y: torch.Tensor, E: torch.Tensor, first: int, discrepancy: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All k - 1 k-means++ picks of a pool Y (n, m) f32 after the first, from
    exponentials E (k - 1, n) f64 on Y's device, in one launch ->
    picks (k,) int64, centroids (k, m) f32 (the picked rows), and a flag
    tensor, non-zero where a draw's sum of weights was 0 or not finite
    (``ref.kmeanspp_seed_ref``'s rule and outputs)."""
    if discrepancy not in ("l2", "l1"):
        raise ValueError(f"unknown discrepancy {discrepancy!r}")
    if Y.ndim != 2 or E.ndim != 2 or E.shape[1] != Y.shape[0]:
        raise ValueError(f"kmeanspp_seed wants Y (n, m) and E (k - 1, n), got "
                         f"{tuple(Y.shape)} and {tuple(E.shape)}")
    if not 0 <= first < Y.shape[0]:
        raise ValueError(f"first pick {first} is not a row of {Y.shape[0]}")
    if Y.dtype != torch.float32 or E.dtype != torch.float64:
        raise TypeError(f"kmeanspp_seed wants Y f32 and E f64, got {Y.dtype} and {E.dtype}")
    if E.device != Y.device or not (Y.is_contiguous() and E.is_contiguous()):
        raise ValueError("Y and E must be contiguous and on one device")
    n, m = Y.shape
    k = E.shape[0] + 1
    if Y.device.type == "cpu":
        return kmeanspp_seed_ref(Y, (E,), first, k, discrepancy)
    cluster = cluster_size(n, m)
    if cluster == 0:
        raise ValueError(f"a pool of {n} x {m} f32 does not fit a cluster's shared memory")
    picks = torch.empty((k,), dtype=torch.int64, device=Y.device)
    centroids = torch.empty((k, m), dtype=torch.float32, device=Y.device)
    err = torch.zeros((1,), dtype=torch.int32, device=Y.device)
    rc = _lib().kmeanspp_seed_f32(
        Y.data_ptr(), E.data_ptr(), picks.data_ptr(), centroids.data_ptr(), err.data_ptr(),
        n, m, k, first, int(discrepancy == "l1"), cluster,
        torch.cuda.current_stream(Y.device).cuda_stream,
    )
    build.check(rc, "kmeanspp_seed launch")
    global launches
    with build.LAUNCH_LOCK:
        launches += 1
    return picks, centroids, err
