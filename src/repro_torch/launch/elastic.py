"""Restores that do not depend on the device layout that saved them.

Checkpoints carry no device placement (the manifest holds logical shapes
only), so a clustering artifact or a mid-fit Lloyd state saved by one run
loads in another, on whatever device count it has:

  * `restore_cluster_model` / `restore_sweep_result`: loads of the
    `ClusterModel` / `SweepResult` checkpoints onto a given device (default:
    the card);
  * `resume_lloyd_state`: adopt a mid-fit Lloyd checkpoint whatever device
    count wrote it; every adoption counts as ``pool.ckpt_resumes``, and one
    whose device count changed between save and resume also as
    ``pool.elastic_resumes`` (`repro_torch.obs` counters;
    ``distributed.checkpoint.COUNTERS`` views them).

`reshard_restore`, the LM training half's restore onto a new mesh, is not
ported yet.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.distributed import checkpoint as ckpt_lib


def reshard_restore(ckpt_dir: str | Path, cfg, policy, opt_cfg, mesh):
    """The LM train state restored onto ``mesh``: not ported yet."""
    raise NotImplementedError(
        "reshard_restore needs the LM training stack (train loop, optimizer, "
        "sharding rules), which is not ported yet (ROADMAP.md Queue 1 item 15)"
    )


def restore_cluster_model(ckpt_dir: str | Path, *, step: int | None = None, device=None):
    """A `ClusterModel` checkpoint on ``device`` (default: the card),
    whatever device count fit it."""
    return ckpt_lib.load_cluster_model(ckpt_dir, step=step, device=device)


def restore_sweep_result(ckpt_dir: str | Path, *, step: int | None = None, device=None):
    """A `SweepResult` checkpoint on ``device`` (see `restore_cluster_model`)."""
    return ckpt_lib.load_sweep_result(ckpt_dir, step=step, device=device)


def resume_lloyd_state(ckpt_dir: str | Path, *, fingerprint: dict,
                       devices_used: int | None = None):
    """The saved mid-fit Lloyd state matching ``fingerprint``, or None.
    Counts every adoption (``pool.ckpt_resumes``) and flags an elastic one
    (``pool.elastic_resumes``: the device count changed between save and resume;
    the state holds no placement, so it is adopted all the same).
    ``devices_used`` is the resuming run's device count (default: the
    visible cards, or 1 without one)."""
    state = ckpt_lib.load_lloyd_state(ckpt_dir, fingerprint=fingerprint)
    if state is None:
        return None
    ckpt_lib.count("ckpt_resumes")
    saved = int(state.get("devices_used", 0))
    now = int(devices_used) if devices_used else max(1, torch.cuda.device_count())
    if saved and saved != now:
        ckpt_lib.count("elastic_resumes")
    return state
