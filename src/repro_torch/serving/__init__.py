"""repro_torch.serving — the high-QPS online assignment tier.

The missing layer between the fit/sweep planes and real traffic: concurrent
request intake with admission control (`ServingTier`, typed `Shed`
rejections past the in-flight bound), a multi-model `ModelRegistry` (several
named `ClusterModel`s live at once, each with its own embed+assign closure
on the card), zero-downtime hot swap to a freshly fit or swept
winner (`registry.swap` — warm off the hot path, atomic pointer flip, no
torn batches), and an open-loop Poisson load generator for honest latency
measurement (`run_open_loop`).

    from repro_torch.serving import ModelRegistry, ServingTier

    registry = ModelRegistry(max_batch=256)
    registry.register("default", "ckpt/")        # ClusterModel / SweepResult
    with ServingTier(registry, max_inflight=4096) as tier:   # / ckpt path
        fut = tier.submit(request_id, x_row)
        label = fut.result().label
        registry.swap("default", "ckpt_v2/")     # zero downtime, versioned

The swap-consistency argument is in `server.py`'s docstring.
"""
from repro_torch.serving.admission import AdmissionController, Shed
from repro_torch.serving.loadgen import LoadGenReport, run_open_loop
from repro_torch.serving.registry import ModelRegistry, ServingModel, make_process_fn
from repro_torch.serving.server import ServeRequest, ServeResponse, ServingTier

__all__ = [
    "AdmissionController",
    "LoadGenReport",
    "ModelRegistry",
    "ServeRequest",
    "ServeResponse",
    "ServingModel",
    "ServingTier",
    "Shed",
    "make_process_fn",
    "run_open_loop",
]
