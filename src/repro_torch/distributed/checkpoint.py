"""Crash-safe checkpoints, in the JAX package's on-disk format.

  * a checkpoint is a directory ``step_<n>/`` holding one .npz of path-keyed
    leaves per tree ("coeffs", "centroids", "state", ...) and a
    ``manifest.json`` with shapes, dtypes, the step and free-form meta. It
    records no device: a restore puts the arrays wherever the restoring run
    asks;
  * writes are crash-atomic: tmp dir, fsync of the manifest, ``os.replace``;
    the ``latest`` pointer is written last, so a kill at any point leaves the
    previous state loadable;
  * ``keep_last`` bounds disk use;
  * ``AsyncCheckpointer`` snapshots to host numpy on the caller's thread and
    serializes on a worker thread.

A tree is a nested dict, list, tuple or NamedTuple whose leaves are tensors
or arrays; its npz keys join the path with "/" as the JAX package names
them (dict key, sequence index, field name), so a checkpoint written by
either package loads in the other. The same holds for the clustering
artifacts built on it: ``save_cluster_model`` (a ``ClusterModel``),
``save_sweep_result`` (a ``SweepResult``) and the mid-fit Lloyd state.

Saves and resumes are counted in `repro_torch.obs` under the JAX package's
names; ``COUNTERS`` is a view of them and ``reset_counters()`` zeroes them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.obs.metrics import MetricsView

_SEP = "/"

#: Mid-fit Lloyd checkpoints since the last ``reset_counters()``: states
#: saved (``pool.ckpt_saves``), states adopted on resume
#: (``pool.ckpt_resumes``), and adoptions by a run on another device count
#: than the one that saved (``pool.elastic_resumes``); a read-only view of
#: the `repro_torch.obs` counters under their short names.
_COUNTER_NAMES = ("ckpt_saves", "ckpt_resumes", "elastic_resumes")
COUNTERS = MetricsView(**{name: (obs.counter(f"pool.{name}"), int) for name in _COUNTER_NAMES})


def count(name: str) -> None:
    obs.counter(f"pool.{name}").inc()


def reset_counters() -> None:
    """Zero the checkpoint counters (measurement scoping)."""
    for name in _COUNTER_NAMES:
        obs.reset_metrics(f"pool.{name}")


@contextlib.contextmanager
def atomic_publish_dir(parent: str | Path, final_name: str) -> Iterator[Path]:
    """Crash-atomic directory publication, shared by checkpoints, the
    sweep's embed stage and the mid-fit Lloyd state. Yields a tmp dir to
    fill; on a clean exit it is ``os.replace``d onto ``parent/final_name``
    (readers see the old version or the new one, never a partial write); on
    an error it is removed."""
    parent = Path(parent)
    parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".tmp_{final_name}_", dir=parent))
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    final = parent / final_name
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)


def fsync_json(path: str | Path, obj: Any) -> None:
    """Write strict JSON and fsync before returning: the manifest must be
    durable before the directory rename that publishes it."""
    with Path(path).open("w") as f:
        json.dump(obj, f, allow_nan=False)
        f.flush()
        os.fsync(f.fileno())


#: numpy has no bfloat16. A bf16 leaf crosses the host as its bits in 2-byte
#: void records (``V2``), the layout ``np.savez`` gives the JAX package's
#: ml_dtypes bfloat16 arrays; the manifest names its dtype ``bfloat16``.
_BF16_BITS = np.dtype("V2")


def _is_bf16_bits(arr: np.ndarray) -> bool:
    """A 2-byte void dtype: ``V2`` records, or ml_dtypes' bfloat16."""
    return arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def host_array(x) -> np.ndarray:
    """A tensor or array-like as a host numpy array (a tensor on the card is
    copied to the host; the copy is synchronous); a bf16 tensor as its bits,
    ``V2`` records."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16_BITS)
        return x.numpy()
    return np.asarray(x)


def from_host(arr) -> torch.Tensor:
    """``host_array``'s inverse: a CPU tensor of the array, 2-byte void records
    (bf16 bits, as either package writes them) as bfloat16, bit for bit."""
    arr = np.asarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    if _is_bf16_bits(arr):
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def dtype_name(arr: np.ndarray) -> str:
    """The manifest's name of a host array's dtype: ``bfloat16`` for bf16 bits."""
    return "bfloat16" if _is_bf16_bits(arr) else str(arr.dtype)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[str, Any]]:
    """(key, leaf) pairs in the JAX package's flattening order: dict keys
    sorted, sequences by index, NamedTuples by field. None is an empty
    subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield _SEP.join(str(p) for p in path), tree


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: host_array(leaf) for key, leaf in _leaves(tree)}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _rebuild(template: Any, leaves: Iterator) -> Any:
    """``template``'s containers with its leaves replaced, in ``_leaves``
    order, by the next values of ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(getattr(template, n), leaves)
                                for n in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def save(
    ckpt_dir: str | Path,
    step: int,
    trees: dict[str, Any],
    *,
    keep_last: int = 3,
    extra_meta: dict | None = None,
) -> Path:
    """Atomically write ``trees`` (e.g. {"coeffs": ..., "centroids": ...})."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    with atomic_publish_dir(ckpt_dir, final.name) as tmp:
        manifest = {"step": step, "trees": {}, "meta": extra_meta or {}}
        for name, tree in trees.items():
            flat = _flatten(tree)
            np.savez(tmp / f"{name}.npz", **flat)
            manifest["trees"][name] = {
                k: {"shape": list(v.shape), "dtype": dtype_name(v)} for k, v in flat.items()
            }
        fsync_json(tmp / "manifest.json", manifest)
    # `latest` is written last: readers never see a partial checkpoint
    latest_tmp = ckpt_dir / ".latest.tmp"
    latest_tmp.write_text(final.name)
    os.replace(latest_tmp, ckpt_dir / "latest")
    _cleanup(ckpt_dir, keep_last)
    return final


def _cleanup(ckpt_dir: Path, keep_last: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> int | None:
    """The step the ``latest`` pointer names, or None when there is no
    pointer or its step has no manifest."""
    ckpt_dir = Path(ckpt_dir)
    pointer = ckpt_dir / "latest"
    if not pointer.exists():
        return None
    name = pointer.read_text().strip()
    if not (ckpt_dir / name / "manifest.json").exists():
        return None
    return int(name.split("_")[1])


def _step_dir(ckpt_dir: Path, step: int | None) -> tuple[int, Path]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return step, ckpt_dir / f"step_{step:08d}"


def restore(
    ckpt_dir: str | Path,
    templates: dict[str, Any],
    *,
    step: int | None = None,
    device=None,
    shardings: dict[str, Any] | None = None,
) -> tuple[int, dict[str, Any]]:
    """Restore trees shaped like ``templates``: the same containers, whose
    leaves are tensors or arrays (or ``torch.empty(shape, dtype=...,
    device="meta")``) giving each leaf's shape and dtype. Returns (step,
    trees) with every leaf a tensor on ``device`` (default: the card).

    ``shardings`` maps a tree's name to a tree of the same containers whose
    leaves are ``sharding.NamedSharding`` (``sharding.to_shardings``): each
    of its leaves is read on the host and placed by its spec over its mesh
    (a `sharding.Sharded`), whatever mesh wrote the checkpoint — the
    elastic re-shard on restore."""
    ckpt_dir = Path(ckpt_dir)
    step, d = _step_dir(ckpt_dir, step)
    manifest = json.loads((d / "manifest.json").read_text())
    shardings = shardings or {}
    dev = None if set(templates) <= set(shardings) else resolve_device(device)
    out: dict[str, Any] = {}
    for name, template in templates.items():
        where = [s for _, s in _leaves(shardings[name])] if name in shardings else None
        with np.load(d / f"{name}.npz") as data:
            leaves = []
            for n, (key, t) in enumerate(_leaves(template)):
                arr = data[key]
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"{name}/{key}: shape {arr.shape} != {tuple(t.shape)}")
                x = from_host(arr).to(dtype=_torch_dtype(t.dtype))
                if where is None:
                    leaves.append(x.to(dev))
                else:
                    leaves.append(sharding.place_leaf(where[n].mesh, x, where[n].spec, key))
        out[name] = _rebuild(template, iter(leaves))
    return manifest["step"], out


def _manifest(ckpt_dir: Path, step: int) -> dict:
    return json.loads((ckpt_dir / f"step_{step:08d}" / "manifest.json").read_text())


def _templates(manifest: dict, tree_name: str) -> dict:
    return {k: torch.empty(tuple(v["shape"]), dtype=_torch_dtype(v["dtype"]), device="meta")
            for k, v in manifest["trees"][tree_name].items()}


# ------------------------------------------------------------ ClusterModel


def save_cluster_model(ckpt_dir: str | Path, model, *, step: int = 0) -> Path:
    """Persist a ``ClusterModel``: the fitted embedding params' arrays and the
    final centroids as npz trees; the member's name and config, the inertia
    and the fit's ``FitMeta`` in the manifest. The JAX package's
    ``load_cluster_model`` reads it, and this module's reads the JAX
    package's."""
    from repro_torch.core.apnc import APNCCoefficients
    from repro_torch.embed import embedding_for

    emb = embedding_for(model.params)
    arrays, config = emb.params_state(model.params)
    # meta.method is authoritative when recorded; nystrom and sd share a
    # params type, and their discrepancy tells them apart otherwise.
    method = model.meta.method
    if method == "unknown":
        if isinstance(model.params, APNCCoefficients):
            method = "nystrom" if model.params.discrepancy == "l2" else "sd"
        else:
            method = emb.name
    trees = {"coeffs": arrays, "centroids": {"centroids": model.centroids}}
    inertia = float(model.inertia)
    kernel = getattr(model.params, "kernel", None)
    meta = {
        "clustering": {
            "embedding": {"method": method, "config": config},
            # the flat keys of the artifacts written before the embedding
            # registry, for their readers
            "discrepancy": model.params.discrepancy,
            **({"kernel": dataclasses.asdict(kernel)} if kernel is not None else {}),
            # None, not NaN: the manifest stays strict JSON
            "inertia": inertia if math.isfinite(inertia) else None,
            "fit": dataclasses.asdict(model.meta),
        }
    }
    return save(ckpt_dir, step, trees, extra_meta=meta)


def load_cluster_model(ckpt_dir: str | Path, *, step: int | None = None, device=None):
    """Inverse of ``save_cluster_model``: a ``ClusterModel`` on ``device``
    (default: the card). An artifact written before the embedding registry
    has no "embedding" key and is read as APNC coefficients."""
    from repro_torch.api.model import ClusterModel, FitMeta
    from repro_torch.core.apnc import APNCCoefficients
    from repro_torch.core.kernels_fn import Kernel
    from repro_torch.embed import get_embedding

    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    step, _ = _step_dir(ckpt_dir, step)
    manifest = _manifest(ckpt_dir, step)
    meta = manifest["meta"]["clustering"]
    _, out = restore(
        ckpt_dir,
        {"coeffs": _templates(manifest, "coeffs"),
         "centroids": _templates(manifest, "centroids")},
        step=step, device="cpu",
    )
    arrays = {k: v.numpy() for k, v in out["coeffs"].items()}
    if "embedding" in meta:
        emb = get_embedding(meta["embedding"]["method"])
        params = emb.params_restore(arrays, meta["embedding"]["config"], device=dev)
    else:  # an artifact from before the embedding registry
        params = APNCCoefficients(
            landmarks=out["coeffs"]["landmarks"].to(dev), R=out["coeffs"]["R"].to(dev),
            kernel=Kernel(**meta["kernel"]), discrepancy=meta["discrepancy"],
        )
    raw_inertia = meta.get("inertia")
    return ClusterModel(
        params=params,
        centroids=out["centroids"]["centroids"].to(dev),
        inertia=torch.tensor(float("nan") if raw_inertia is None else raw_inertia,
                             dtype=torch.float32, device=dev),
        meta=FitMeta(**meta["fit"]) if "fit" in meta else FitMeta(),
    )


# ------------------------------------------------------------- SweepResult


def save_sweep_result(ckpt_dir: str | Path, result, *, step: int = 0) -> Path:
    """Persist a ``SweepResult``: the shared embedding params once, every
    candidate's centroids as one stacked (R, k, m) tree per k-grid entry, the
    inertia table and the selection. Labels are not persisted (``predict``
    gives them again)."""
    from repro_torch.embed import embedding_for

    params = result.models[0][0].params  # shared by every candidate
    arrays, config = embedding_for(params).params_state(params)
    trees: dict = {
        "coeffs": arrays,
        # f32, as ClusterModel.inertia and the JAX package's restore
        "inertia": {"inertia": np.asarray(result.inertia, np.float32)},
    }
    for i in range(len(result.k_grid)):
        trees[f"centroids_k{i}"] = {
            "centroids": np.stack([host_array(m.centroids) for m in result.models[i]])
        }
    meta = {
        "sweep": {
            "k_grid": [int(k) for k in result.k_grid],
            "restarts": int(result.restarts),
            "backend": result.backend,
            "best": [int(result.best_k_index), int(result.best_restart)],
            "embedding": {"method": result.models[0][0].meta.method, "config": config},
            "fit": [[dataclasses.asdict(m.meta) for m in row] for row in result.models],
        }
    }
    return save(ckpt_dir, step, trees, extra_meta=meta)


def load_sweep_result(ckpt_dir: str | Path, *, step: int | None = None, device=None):
    """Inverse of ``save_sweep_result``: a ``SweepResult`` whose models share
    one restored params, on ``device`` (default: the card). ``labels`` is
    None; the selection is the saved one."""
    from repro_torch.api.model import ClusterModel, FitMeta
    from repro_torch.embed import get_embedding
    from repro_torch.sweep.result import SweepResult

    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    step, _ = _step_dir(ckpt_dir, step)
    manifest = _manifest(ckpt_dir, step)
    meta = manifest["meta"]["sweep"]
    names = ["coeffs", "inertia"] + [f"centroids_k{i}" for i in range(len(meta["k_grid"]))]
    _, out = restore(ckpt_dir, {name: _templates(manifest, name) for name in names},
                     step=step, device="cpu")
    arrays = {k: v.numpy() for k, v in out["coeffs"].items()}
    params = get_embedding(meta["embedding"]["method"]).params_restore(
        arrays, meta["embedding"]["config"], device=dev)
    inertia = out["inertia"]["inertia"].numpy()
    models = []
    for i in range(len(meta["k_grid"])):
        stacked = out[f"centroids_k{i}"]["centroids"].to(dev)
        models.append([
            ClusterModel(
                params=params, centroids=stacked[r].clone(),
                inertia=torch.tensor(float(inertia[i, r]), dtype=torch.float32, device=dev),
                meta=FitMeta(**meta["fit"][i][r]),
            )
            for r in range(int(meta["restarts"]))
        ])
    return SweepResult(
        models=models, inertia=inertia, labels=None, k_grid=tuple(meta["k_grid"]),
        restarts=int(meta["restarts"]), backend=meta["backend"],
        best_k_index=int(meta["best"][0]), best_restart=int(meta["best"][1]),
    )


def load_any_model(ckpt_dir: str | Path, *, step: int | None = None, device=None):
    """A ``ClusterModel`` from either artifact under ``ckpt_dir``: a
    cluster-model checkpoint as it is, a sweep-result checkpoint by its
    selected winner."""
    ckpt_dir = Path(ckpt_dir)
    step, _ = _step_dir(ckpt_dir, step)
    if "sweep" in _manifest(ckpt_dir, step).get("meta", {}):
        return load_sweep_result(ckpt_dir, step=step, device=device).best
    return load_cluster_model(ckpt_dir, step=step, device=device)


# --------------------------------------------------------------------------
# Mid-fit Lloyd state. A killed fit's sunk cost is its completed passes; the
# state saved after each iteration (each epoch for minibatch) is small: the
# iteration, centroids, labels (the stopping rule compares them), the cost
# trajectory and centroid shifts, and minibatch's decayed (Z, g). It records
# no device or scheduler, so a fit saved by one run resumes under another.

LLOYD_STATE_DIR = "lloyd_state"


def lloyd_fingerprint(*, kind: str, n: int, d: int, k: int, m: int, init,
                      decay: float | None = None, cache_dtype: str = "f32") -> dict:
    """Identity of a Lloyd run for resume matching: the problem's shape and a
    hash of the exact init centroids' f32 bytes, the JAX package's dict for
    the same init. A non-f32 staged-Y codec enters it (a fit over an int8
    cache must not adopt an f32 run's state); f32 is left out."""
    raw = np.ascontiguousarray(host_array(init).astype(np.float32)).tobytes()
    fp = {
        "kind": kind, "n": int(n), "d": int(d), "k": int(k), "m": int(m),
        "init_sha": hashlib.sha256(raw).hexdigest()[:16],
    }
    if decay is not None:
        fp["decay"] = float(decay)
    if cache_dtype != "f32":
        fp["cache_dtype"] = str(cache_dtype)
    return fp


def save_lloyd_state(
    ckpt_dir: str | Path,
    *,
    step: int,
    centroids,
    labels,
    trajectory,
    shifts,
    changed: bool,
    fingerprint: dict,
    devices_used: int,
    stats: dict | None = None,
    keep_last: int = 2,
) -> Path:
    """Crash-atomically persist the state after ``step`` completed iterations
    (epochs for minibatch). ``stats`` holds minibatch's decayed {"Z", "g",
    "seen_cost"}."""
    trees: dict[str, Any] = {
        "state": {
            "centroids": host_array(centroids).astype(np.float32),
            "labels": host_array(labels).astype(np.int32),
            "trajectory": np.asarray(trajectory, np.float64),
            "shifts": np.asarray(shifts, np.float64),
        }
    }
    if stats is not None:
        trees["stats"] = {k: host_array(v) for k, v in stats.items()}
    meta = {"lloyd": {"fingerprint": fingerprint, "changed": bool(changed),
                      "devices_used": int(devices_used)}}
    out = save(Path(ckpt_dir) / LLOYD_STATE_DIR, step, trees, keep_last=keep_last,
               extra_meta=meta)
    count("ckpt_saves")
    return out


def load_lloyd_state(ckpt_dir: str | Path, *, fingerprint: dict) -> dict | None:
    """The latest saved Lloyd state under ``ckpt_dir`` as host arrays, or
    None when there is none or its fingerprint differs (another data set, k
    or init: start afresh, never adopt foreign centroids)."""
    state_dir = Path(ckpt_dir) / LLOYD_STATE_DIR
    step = latest_step(state_dir)
    if step is None:
        return None
    d = state_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    meta = manifest.get("meta", {}).get("lloyd")
    if not meta or meta.get("fingerprint") != fingerprint:
        return None
    with np.load(d / "state.npz") as data:
        out = {
            "step": int(manifest["step"]),
            "changed": bool(meta["changed"]),
            "devices_used": int(meta.get("devices_used", 0)),
            "centroids": np.asarray(data["centroids"], np.float32),
            "labels": np.asarray(data["labels"], np.int32),
            "trajectory": [float(v) for v in data["trajectory"]],
            "shifts": [float(v) for v in data["shifts"]],
            "stats": None,
        }
    stats_path = d / "stats.npz"
    if stats_path.exists():
        with np.load(stats_path) as sdata:
            out["stats"] = {k: np.asarray(sdata[k]) for k in sdata.files}
    return out


# ----------------------------------------------------------- legacy shims


def save_clustering_model(ckpt_dir: str | Path, coeffs, centroids, *, step: int = 0) -> Path:
    """Shim over ``save_cluster_model`` for (coeffs, centroids) call sites;
    the inertia is unknown (written as null)."""
    from repro_torch.api.model import ClusterModel, FitMeta

    centroids = torch.as_tensor(centroids)
    model = ClusterModel(
        params=coeffs, centroids=centroids, inertia=torch.tensor(float("nan")),
        meta=FitMeta(k=int(centroids.shape[0]), kernel_name=coeffs.kernel.name),
    )
    return save_cluster_model(ckpt_dir, model, step=step)


def load_clustering_model(ckpt_dir: str | Path, *, step: int | None = None, device=None):
    """Shim over ``load_cluster_model``: (params, centroids)."""
    model = load_cluster_model(ckpt_dir, step=step, device=device)
    return model.coeffs, model.centroids


class AsyncCheckpointer:
    """Snapshot on the caller's thread, serialize on a worker thread.
    ``wait()`` before the next save or at loop exit; errors re-raise there.

    The snapshot is a synchronous copy of every leaf to fresh host numpy
    arrays, made before the worker starts, after the card has finished all
    queued work (a ``non_blocking`` copy into pinned memory may still be in
    flight otherwise), so the caller may reuse or overwrite its tensors as
    soon as ``save`` returns."""

    def __init__(self, ckpt_dir: str | Path, keep_last: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def save(self, step: int, trees: dict[str, Any], extra_meta: dict | None = None) -> None:
        self.wait()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        host_trees = {
            n: _rebuild(t, (np.array(host_array(leaf), copy=True) for _, leaf in _leaves(t)))
            for n, t in trees.items()
        }

        def work():
            try:
                save(self.ckpt_dir, step, host_trees, keep_last=self.keep_last,
                     extra_meta=extra_meta)
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
