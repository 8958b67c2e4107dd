"""Build the port's objects from plain arrays and dicts.

The JAX package's fitted state (landmarks, R, the RFF frequencies W, the
TensorSketch count-sketches S, centroids, inertia and the static fields) and
its LM params tree are handed over as numpy arrays plus plain dicts, so that
both packages compute from the same state. The LM goes both ways: its params
and its ``AdamWState`` to and from the reference's trees (the layer groups
stacked on axis 0, the same leaf names), which is what a train checkpoint
holds, so a run saved by either package resumes in the other. Nothing here
imports the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.model import ClusterModel, FitMeta
from repro_torch.core.apnc import APNCCoefficients
from repro_torch.core.kernels_fn import Kernel
from repro_torch.device import resolve_device
from repro_torch.embed.rff import RFFParams
from repro_torch.embed.tensorsketch import TensorSketchParams


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(resolve_device(device))


def _kernel(fields: dict) -> Kernel:
    known = {f.name for f in dataclasses.fields(Kernel)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown kernel fields {sorted(unknown)}")
    return Kernel(**fields)


def apnc_params_from_numpy(
    landmarks, R, kernel: dict, discrepancy: str, *, device=None,
) -> APNCCoefficients:
    """APNC coefficients from landmarks (q, l_b, d), R (q, m_b, l_b) and the
    kernel's fields as a dict (name, gamma, degree, coef0, scale), on
    ``device``: the card by default (``resolve_device``), ``"cpu"`` on request."""
    return APNCCoefficients(
        landmarks=_tensor(landmarks, device), R=_tensor(R, device),
        kernel=_kernel(kernel), discrepancy=discrepancy,
    )


def rff_params_from_numpy(W, kernel: dict, *, device=None) -> RFFParams:
    """RFF params from the frequency matrix W (d, m_half) and the kernel's
    fields as a dict, on ``device`` (the card by default)."""
    return RFFParams(W=_tensor(W, device), kernel=_kernel(kernel))


def tensorsketch_params_from_numpy(S, kernel: dict, *, device=None) -> TensorSketchParams:
    """TensorSketch params from the dense count-sketches S (p, d_aug, m) and
    the kernel's fields as a dict, on ``device`` (the card by default)."""
    return TensorSketchParams(S=_tensor(S, device), kernel=_kernel(kernel))


def cluster_model_from_numpy(
    params: APNCCoefficients | RFFParams | TensorSketchParams, centroids, inertia, meta: dict,
) -> ClusterModel:
    """A ClusterModel from converted params, centroids (k, m), the inertia and
    the FitMeta fields as a dict (unknown keys are ignored)."""
    fields = {f.name for f in dataclasses.fields(FitMeta)}
    return ClusterModel(
        params=params,
        centroids=_tensor(centroids, params.device),
        inertia=torch.tensor(float(np.asarray(inertia)), dtype=torch.float32),
        meta=FitMeta(**{k: v for k, v in meta.items() if k in fields}),
    )


def _leaves(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _leaves(value, name + ".")
        else:
            yield name, value


def _by_name(tree: dict, cfg) -> dict:
    """A reference tree's leaves by the port's parameter name, the groups
    unstacked (``groups.layer0.mixer.wq`` (G, ...) -> ``groups.<g>.layer0.mixer.wq``)."""
    out = {}
    for name, leaf in _leaves(tree):
        if name.startswith("groups."):
            if len(leaf.shape) == 0 or leaf.shape[0] != cfg.num_groups:
                raise ValueError(f"{name}: {tuple(leaf.shape)} is not stacked over "
                                 f"{cfg.num_groups} groups")
            for g in range(cfg.num_groups):
                out[f"groups.{g}.{name[len('groups.'):]}"] = leaf[g]
        else:
            out[name] = leaf
    return out


def _tree(named: dict, cfg, leaf, stack) -> dict:
    """The reference's nested tree from leaves by the port's parameter name:
    ``leaf(x)`` for a top-level leaf, ``stack([x_0, .., x_{G-1}])`` for a
    group leaf, which lands on ``groups.<rest>``."""
    tree: dict = {}
    groups: dict = {}

    def put(dotted, value):
        *path, last = dotted.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = value

    for name, x in named.items():
        if name.startswith("groups."):
            _, g, rest = name.split(".", 2)
            groups.setdefault(rest, [None] * cfg.num_groups)[int(g)] = x
        else:
            put(name, leaf(x))
    for rest, xs in groups.items():
        put(f"groups.{rest}", stack(xs))
    return tree


def _numpy_tree(named: dict, cfg) -> dict:
    """Host numpy leaves; a bf16 leaf as its bits (``checkpoint.host_array``)."""
    from repro_torch.distributed.checkpoint import host_array

    with torch.no_grad():
        return _tree(named, cfg, host_array, lambda xs: host_array(torch.stack(xs)))


def _host_tensor(a) -> torch.Tensor:
    """A leaf of a reference tree (a tensor, or an array whose bf16 leaves
    are 2-byte records) as a tensor."""
    from repro_torch.distributed.checkpoint import from_host

    return a if isinstance(a, torch.Tensor) else from_host(a)


def _meta_tree(named: dict, cfg) -> dict:
    def meta(shape, dtype):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")

    return _tree(named, cfg, lambda x: meta(x.shape, x.dtype),
                 lambda xs: meta((len(xs), *xs[0].shape), xs[0].dtype))


def load_lm_params(module, tree: dict, cfg):
    """Copy the reference's params tree (nested dicts of arrays or CPU
    tensors, the groups stacked on axis 0) into ``module``'s parameters, in
    place. Raises ValueError on a leaf that is missing, extra, or of another
    shape."""
    want = dict(module.named_parameters())
    got = _by_name(tree, cfg)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"params tree does not match {cfg.name}: missing {missing}, "
                         f"extra {extra}")
    with torch.no_grad():
        for name, param in want.items():
            if tuple(got[name].shape) != tuple(param.shape):
                raise ValueError(f"{name}: {tuple(got[name].shape)} != {tuple(param.shape)}")
            param.copy_(_host_tensor(got[name]))
    return module


def lm_params_from_numpy(tree: dict, cfg, *, device=None):
    """The port's LM (``models.model.LM``, f32 params) from the reference's
    params tree as nested dicts of numpy arrays, its layer groups stacked on
    axis 0 (``tree["groups"]["layer0"]["mixer"]["wq"]`` is (G, d, H, Dh)).

    Every leaf lands on the parameter of the same dotted name, the groups
    unstacked (``groups.<g>.layer0.mixer.wq``). Raises ValueError on a leaf
    that is missing, extra, or of another shape. ``device`` is the card by
    default (``resolve_device``), ``"cpu"`` on request.
    """
    from repro_torch.models import model as lm
    from repro_torch.models.common import Policy

    return load_lm_params(lm.build(cfg, Policy(), device), tree, cfg)


def _named_params(model) -> dict:
    """An LM module's parameters by name, or the dict of them as given."""
    return dict(model.named_parameters()) if hasattr(model, "named_parameters") else dict(model)


def lm_params_to_numpy(model, cfg) -> dict:
    """The inverse of ``lm_params_from_numpy``: the reference's params tree,
    nested dicts of host numpy arrays with the groups stacked on axis 0.
    ``model`` is the LM or its parameters by name."""
    return _numpy_tree(_named_params(model), cfg)


def adamw_state_to_numpy(state, cfg):
    """An ``AdamWState`` as the reference's: the step an int32 () array, each
    moment the params tree's layout (groups stacked on axis 0), host numpy."""
    from repro_torch.optim.adamw import AdamWState

    return AdamWState(np.asarray(int(state.step), dtype=np.int32),
                      _numpy_tree(state.mu, cfg), _numpy_tree(state.nu, cfg))


def adamw_state_from_numpy(state, cfg, *, device=None):
    """The port's ``AdamWState`` (moments by parameter name, on ``device``,
    the card by default; the step an int32 () tensor on the CPU) from the
    reference's (``step``, ``mu``, ``nu`` trees of arrays)."""
    from repro_torch.optim.adamw import AdamWState

    dev = resolve_device(device)

    def moments(tree):
        return {n: _host_tensor(np.array(a)).to(dev)
                for n, a in _by_name(tree, cfg).items()}

    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32)
    return AdamWState(step, moments(state.mu), moments(state.nu))


def lm_train_state_to_numpy(model, state, cfg) -> dict:
    """A train checkpoint's trees, the reference's: {"params", "opt_state"}."""
    return {"params": lm_params_to_numpy(model, cfg),
            "opt_state": adamw_state_to_numpy(state, cfg)}


def lm_train_state_templates(model, state, cfg) -> dict:
    """``lm_train_state_to_numpy``'s trees as shape and dtype templates (meta
    tensors), for ``checkpoint.restore``."""
    from repro_torch.optim.adamw import AdamWState

    step = torch.empty((), dtype=torch.int32, device="meta")
    return {"params": _meta_tree(_named_params(model), cfg),
            "opt_state": AdamWState(step, _meta_tree(state.mu, cfg), _meta_tree(state.nu, cfg))}


def load_lm_train_state(model, state, trees: dict, cfg):
    """Load a train checkpoint's trees into ``model`` and ``state``'s moments
    in place. Returns (model, the state with the saved step)."""
    from repro_torch.optim.adamw import AdamWState

    load_lm_params(model, trees["params"], cfg)
    saved = trees["opt_state"]
    with torch.no_grad():
        for mine, tree in ((state.mu, saved.mu), (state.nu, saved.nu)):
            got = _by_name(tree, cfg)
            if set(got) != set(mine):
                raise ValueError(f"moments do not match {cfg.name}: "
                                 f"{sorted(set(got) ^ set(mine))}")
            for name, m in mine.items():
                m.copy_(_host_tensor(got[name]))
    step = torch.tensor(int(saved.step), dtype=torch.int32)
    return model, AdamWState(step, state.mu, state.nu)
