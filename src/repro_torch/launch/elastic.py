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

`reshard_restore` is the LM train state's: the same rules
(`distributed.sharding`) place it on whatever mesh the resuming run has
(e.g. a lost node: from (4, 2) to (2, 2)), since a train checkpoint holds
the gathered trees in the reference's layout.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.distributed import checkpoint as ckpt_lib


def reshard_restore(ckpt_dir: str | Path, cfg, policy, opt_cfg, mesh):
    """Returns (step, params, opt_state) placed on ``mesh`` regardless of the
    mesh the checkpoint was written under: params a
    `distributed.parallel.MeshLM`, opt_state an ``AdamWState`` whose moments
    are `Sharded` like the params and whose step is a CPU int32 tensor."""
    from repro_torch import convert
    from repro_torch.distributed import parallel
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw

    model_t = model_lib.build(cfg, policy, "meta")
    opt_t = adamw.init(model_t, opt_cfg)
    specs = shd.stacked(cfg, shd.param_pspecs(cfg, model_t))
    opt_specs = adamw.AdamWState(shd.Spec(), specs, specs)
    step, trees = ckpt_lib.restore(
        ckpt_dir, convert.lm_train_state_templates(model_t, opt_t, cfg),
        shardings={"params": shd.to_shardings(mesh, specs),
                   "opt_state": shd.to_shardings(mesh, opt_specs)})
    params = parallel.MeshLM(cfg, mesh, convert._by_name(trees["params"], cfg))
    saved = trees["opt_state"]
    opt_state = adamw.AdamWState(saved.step.gather("cpu"), convert._by_name(saved.mu, cfg),
                                 convert._by_name(saved.nu, cfg))
    return step, params, opt_state


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
