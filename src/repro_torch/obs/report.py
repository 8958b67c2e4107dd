"""FitReport: the structured answer to "what did that fit actually do".

Every backend fit (and every sweep) produces one: phase wall-times for the
paper's pipeline stages (reservoir -> embed fit -> seed -> lloyd), the
per-iteration inertia trajectory (its last entry IS the model's reported
inertia — the final-pass assignment under the final centroids), centroid
shifts, engine pass counts, blocks/bytes streamed, per-device block counts.
`KernelKMeans` surfaces it as `est.fit_report_` and attaches it to the
ClusterModel as a plain attribute, `model_.report`: reports are measurement,
not model state, and a checkpoint does not carry them, by design (a restored
model's numbers would be lies about the restoring process).

`roofline_join` closes the loop with `repro_torch.roofline.analysis`: measured
phase seconds against the modeled compute/memory/collective terms of the work
the phase executed, so "are we at the roofline or drowning in overhead?" is
one function call.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass
class FitReport:
    """One fit's (or sweep's) measurement record. Plain data — every field
    JSON-serializable via `as_dict()`."""

    backend: str = ""
    phases: dict = dataclasses.field(default_factory=dict)  # name -> seconds
    inertia_trajectory: list = dataclasses.field(default_factory=list)
    centroid_shifts: list = dataclasses.field(default_factory=list)
    iters: int = 0
    rows_seen: int = 0
    pass_counts: dict = dataclasses.field(default_factory=dict)
    blocks_read: int = 0
    bytes_h2d: int = 0
    per_device_blocks: dict = dataclasses.field(default_factory=dict)
    extra: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, path: str | Path | None = None) -> str:
        s = json.dumps(self.as_dict(), indent=2)
        if path is not None:
            Path(path).write_text(s)
        return s

    def summary(self) -> str:
        """One human line: backend, iterations, phase seconds, stream volume."""
        ph = " ".join(f"{k}={v:.3f}s" for k, v in self.phases.items())
        mb = self.bytes_h2d / 1e6
        tail = (f" inertia={self.inertia_trajectory[-1]:.4g}"
                if self.inertia_trajectory else "")
        return (f"[{self.backend}] iters={self.iters} rows={self.rows_seen} "
                f"blocks={self.blocks_read} h2d={mb:.1f}MB {ph}{tail}")


def report_from_metrics_delta(d: dict) -> dict:
    """Split an `obs.delta()` of engine metrics into FitReport field values
    (pass_counts / blocks_read / bytes_h2d / per_device_blocks)."""
    passes = {
        name[len("engine.passes."):]: int(v)
        for name, v in d.items()
        if name.startswith("engine.passes.") and v
    }
    per_device = {
        name[len("engine.device_blocks."):]: int(v)
        for name, v in d.items()
        if name.startswith("engine.device_blocks.") and v
    }
    return dict(
        pass_counts=passes,
        blocks_read=int(d.get("engine.blocks_read", 0)),
        bytes_h2d=int(d.get("engine.bytes_h2d", 0)),
        per_device_blocks=per_device,
    )


# --------------------------------------------------------- roofline join


def roofline_join(measured_s: float, rec: dict, *, chips: int = 1,
                  links: int = 1) -> dict:
    """Join a measured wall-time against the modeled roofline of the work it
    executed.

    `rec` follows the dry-run record convention: `flops`, `hbm_bytes` (or
    `bytes`), optional `collective_bytes`. Returns the
    `repro_torch.roofline.analysis.roofline_terms` dict extended with:

      modeled_s       the binding-resource time, max of the three terms
      measured_s      the span/phase wall time handed in
      model_fraction  modeled_s / measured_s — 1.0 means the phase ran at the
                      machine roofline; small values are host/dispatch/ingest
                      overhead the model does not see.
    """
    from repro_torch.roofline.analysis import roofline_terms

    terms = roofline_terms(
        flops=float(rec.get("flops", 0.0)),
        bytes_hbm=float(rec.get("hbm_bytes", rec.get("bytes", 0.0))),
        collective_bytes=float(rec.get("collective_bytes", 0.0)),
        chips=chips, links=links,
    )
    modeled = max(terms["t_compute_s"], terms["t_memory_s"],
                  terms["t_collective_s"])
    out = dict(terms)
    out["modeled_s"] = modeled
    out["measured_s"] = float(measured_s)
    out["model_fraction"] = (modeled / measured_s) if measured_s > 0 else 0.0
    return out


def join_fit_roofline(report: FitReport, rec: dict, *, phase: str = "lloyd",
                      chips: int = 1, links: int = 1) -> dict:
    """Per-PASS join for a fit: the named phase's wall time divided by the
    engine passes the fit recorded, against the modeled cost of one pass
    (`rec`). Falls back to iters+1 passes when no pass counts were captured
    (e.g. the resident local backend)."""
    passes = sum(report.pass_counts.values()) or (report.iters + 1)
    per_pass = report.phases.get(phase, 0.0) / max(passes, 1)
    out = roofline_join(per_pass, rec, chips=chips, links=links)
    out["passes"] = int(passes)
    return out
