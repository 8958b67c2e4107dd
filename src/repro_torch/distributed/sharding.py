"""Sharding rules of the LM over a device mesh, and the placement they drive.

Axis semantics (the reference's, DESIGN.md section 6):
    "model"          tensor parallelism (heads / d_ff / vocab / d_inner)
    "data"           data parallelism + FSDP storage sharding (ZeRO) of params
                     and optimizer state (cfg.zero_shard_params)
    "pod"            2nd-level data parallelism (FSDP gathers stay intra-pod)

A ``Spec`` is the port's ``PartitionSpec``: a tuple with one entry per
dimension, each an axis name, a tuple of axis names, or ``None``
(replicated). Rules are keyed on (context, name, ndim) where context is
"mixer" / "ffn" / top-level. The port's layer groups are unstacked
(``groups.<g>.layer<i>...``), so a group leaf's spec is the reference's
without its leading ``None``; ``stacked`` gives the reference's layout back.

In place of ``NamedSharding`` + ``jax.device_put``, ``place(mesh, tree,
specs)`` cuts every leaf into one block per distinct slice of the mesh (a
dimension split over axes of total size n into n equal blocks, a dimension
not split replicated) and ``gather`` is its inverse. A block lives once, on
the device of the first mesh coordinate that holds it (its owner); a
coordinate on another device reads it through ``Sharded.block`` or
``Sharded.take``, copies that autograd carries gradients back through.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, ArchConfig


class Spec(tuple):
    """The port's PartitionSpec: one entry per dimension (an axis name, a
    tuple of names, or None); shorter than the tensor's rank means the rest
    are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def fsdp_axis(cfg: ArchConfig) -> str | None:
    """FSDP storage axis — intra-pod only (cross-pod gathers would dominate)."""
    return "data" if cfg.zero_shard_params else None


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _param_rule(cfg: ArchConfig, context: str, name: str, ndim: int) -> Spec:
    """Spec for an UNSTACKED param. `context` in {"mixer","ffn","top"}."""
    f = fsdp_axis(cfg)
    P = Spec
    if context == "top":
        if name == "embed":
            return P(None, "model", f) if ndim == 3 else P("model", f)
        if name == "head":
            return P(None, f, "model") if ndim == 3 else P(f, "model")
        return P()  # final_norm
    if context == "mixer":
        attn = {
            "wq": P(f, "model", None),
            "wk": P(f, None, None),  # KV heads replicated over model (GQA)
            "wv": P(f, None, None),
            "wo": P("model", None, f),
            "bq": P("model", None),
            "bk": P(),
            "bv": P(),
            "q_scale": P(),
            "k_scale": P(),
        }
        mamba = {
            "in_proj": P(f, "model"),
            "conv_w": P(None, "model"),
            "conv_b": P("model"),
            "x_proj": P("model", None),
            "dt_proj": P(None, "model"),
            "dt_bias": P("model"),
            "A_log": P("model", None),
            "D": P("model"),
            "out_proj": P("model", f),
        }
        rwkv = {
            "mu_x": P(),
            "mu": P(),
            "lora_A": P(f, None),
            "lora_B": P(),
            "wr": P(f, "model"),
            "wk": P(f, "model"),
            "wv": P(f, "model"),
            "wg": P(f, "model"),
            "wo": P("model", f),
            "w0": P("model"),
            "wA": P(f, None),
            "wB": P(None, "model"),
            "u": P("model", None),
            "ln_scale": P("model"),
            "ln_bias": P("model"),
        }
        # disambiguate wk/wv/wo/wr between attention (3D) and rwkv (2D)
        if name in attn and ndim == len(attn[name]):
            return attn[name]
        if name in rwkv and ndim == len(rwkv[name]):
            return rwkv[name]
        if name in attn:
            return attn[name]
        if name in rwkv:
            return rwkv[name]
        if name in mamba:
            return mamba[name]
        raise KeyError(f"no mixer rule for {name} ndim={ndim}")
    if context == "ffn":
        ffn = {
            # dense mlp / rwkv cmix (2D) and moe experts (3D)
            "wi": P(f, "model") if ndim == 2 else P(None, f, "model"),
            "wo": P("model", f) if ndim == 2 else P(None, "model", f),
            "router": P(f, None),
            "shared_wi": P(f, "model"),
            "shared_wo": P("model", f),
            "shared_gate": P(),
            "mu_k": P(),
            "mu_r": P(),
            "wk": P(f, "model"),
            "wv": P("model", f),
            "wr": P(f, None),
        }
        if name in ffn:
            return ffn[name]
        raise KeyError(f"no ffn rule for {name} ndim={ndim}")
    raise KeyError(context)


def _name_context(name: str) -> tuple[str, str]:
    """(context, leaf name) of a dotted parameter name."""
    keys = name.split(".")
    if "mixer" in keys:
        return "mixer", keys[-1]
    if "ffn" in keys:
        return "ffn", keys[-1]
    return "top", keys[-1]


def param_pspecs(cfg: ArchConfig, params) -> dict[str, Spec]:
    """The spec of each of the port's parameters, by name: ``params`` is an
    ``nn.Module`` (the LM, on any device, ``meta`` too) or a dict of tensors
    by name. A group leaf (``groups.<g>.``) is unstacked: its spec is the
    reference's without the leading ``None``."""
    named = dict(params.named_parameters()) if hasattr(params, "named_parameters") \
        else dict(params)
    specs = {}
    for name, leaf in named.items():
        ctx, leaf_name = _name_context(name)
        if ctx == "top" and leaf_name in ("norm1", "norm2"):
            specs[name] = Spec()
        else:
            specs[name] = _param_rule(cfg, ctx, leaf_name, leaf.ndim)
    return specs


def stacked(cfg: ArchConfig, named_specs: dict[str, Spec]) -> dict:
    """Name-keyed specs in the reference's params tree: nested dicts, the
    groups stacked on a leading axis that is not split (``Spec(None, ...)``)."""
    from repro_torch import convert

    return convert._tree(named_specs, cfg, lambda s: s, lambda ss: Spec(None, *ss[0]))


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def _dp_degree(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def batch_pspecs(cfg: ArchConfig, shape_name: str, mesh) -> dict[str, Spec]:
    """Specs for the input batch dict of a given shape. long_500k (batch=1)
    replicates the batch dim (the sequence is sharded in the CACHE instead)."""
    s = SHAPES[shape_name]
    return {k: batch_spec(mesh, s.batch, v.ndim) for k, v in cfg.input_specs(shape_name).items()}


def batch_spec(mesh, batch: int, ndim: int) -> Spec:
    """A batch leaf's spec: rows split over the data axes, or replicated when
    the batch is smaller than the data degree."""
    b = None if batch < _dp_degree(mesh) else dp_axes(mesh)
    return Spec(b, *([None] * (ndim - 1)))


def cache_pspecs(cfg: ArchConfig, shape_name: str, mesh, cache: list) -> list:
    """Specs for the decode cache: the port's list of one dict a group,
    ``{"layer<i>": {name: tensor}}`` (no group dimension).

    decode_32k: batch-shard the cache; long_500k (batch=1): shard the KV cache
    SEQUENCE dim over the dp axes (distributed flash-decode) — SSM states have no
    sequence dim and replicate over dp while sharding heads/d_inner over "model".
    """
    return cache_specs(mesh, cache, SHAPES[shape_name].batch < _dp_degree(mesh))


def cache_specs(mesh, cache: list, seq_shard: bool) -> list:
    """``cache_pspecs`` for a cache whose layout is given: ``seq_shard``
    splits the positions of k / v over the data axes and replicates the
    batch, else the batch is split."""
    dp = dp_axes(mesh)
    b = None if seq_shard else dp

    def spec_for(name: str) -> Spec:
        if name in ("k", "v"):  # (B, T, KV, Dh)
            return Spec(b, dp if seq_shard else None, None, None)
        if name in ("k_scale", "v_scale"):  # (B, T, KV) int8-cache scales
            return Spec(b, dp if seq_shard else None, None)
        if name == "h":  # mamba (B, di, N)
            return Spec(b, "model", None)
        if name == "conv":  # (B, W-1, di)
            return Spec(b, None, "model")
        if name == "S":  # rwkv (B, Hp, hs, hs)
            return Spec(b, "model", None, None)
        if name in ("x_tmix", "x_cmix"):  # (B, 1, d)
            return Spec(b, None, None)
        raise KeyError(name)

    return [{layer: {name: spec_for(name) for name in state} for layer, state in group.items()}
            for group in cache]


def opt_state_pspecs(cfg: ArchConfig, params, opt_state) -> Any:
    """AdamWState(step, mu, nu): moments mirror the param specs (ZeRO)."""
    pspecs = param_pspecs(cfg, params)
    return type(opt_state)(step=Spec(), mu=pspecs, nu=dict(pspecs))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Sharded:
    """A tensor of global ``shape`` cut over ``mesh`` by ``spec``: one block
    per distinct slice, ``blocks[index]`` where ``index`` holds the block's
    number along each dimension, each on its owner's device (the first mesh
    coordinate, in row-major order, that holds it)."""

    def __init__(self, mesh, spec: Spec, shape, blocks: dict):
        self.mesh, self.spec, self.shape = mesh, spec, torch.Size(shape)
        self.blocks = blocks
        self._dims = [_axes(e) for e in spec] + [()] * (len(self.shape) - len(spec))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.blocks.values())).dtype

    def splits(self) -> tuple[int, ...]:
        """The number of blocks along each dimension."""
        return tuple(math.prod(self.mesh.shape[a] for a in axes) for axes in self._dims)

    def index(self, coord: tuple) -> tuple[int, ...]:
        """The block a mesh coordinate holds."""
        pos = dict(zip(self.mesh.axis_names, coord))
        out = []
        for axes in self._dims:
            i = 0
            for a in axes:  # row-major over the entry's axes, the first major
                i = i * self.mesh.shape[a] + pos[a]
            out.append(i)
        return tuple(out)

    def block(self, coord: tuple) -> torch.Tensor:
        """The block of ``coord`` on that coordinate's device."""
        return self.blocks[self.index(coord)].to(self.mesh.devices[coord])

    def take(self, device, ranges, coord: tuple | None = None) -> torch.Tensor:
        """The part of the global tensor that ``ranges`` names, on ``device``:
        one entry a dimension, ``None`` for all of it or a list of
        (start, stop) index ranges, concatenated in order. Each overlapping
        block is sliced on its owner's device, then copied. With the mesh
        coordinate ``coord`` taking it, the bytes read from blocks that the
        coordinate does not hold by the spec are a gather
        (``launch.mesh.note_transfer``)."""
        from repro_torch.launch.mesh import _WATCHERS, note_transfer

        own = self.index(coord) if coord is not None and _WATCHERS else None
        ranges = list(ranges) + [None] * (self.ndim - len(ranges))
        sizes = [n // k for n, k in zip(self.shape, self.splits())]
        pieces = []
        for n, size, rs in zip(self.shape, sizes, ranges):
            dim = []
            for lo, hi in (rs if rs is not None else [(0, n)]):
                for b in range(lo // size, -(-hi // size)):
                    dim.append((b, max(lo, b * size) - b * size, min(hi, (b + 1) * size) - b * size))
            pieces.append(dim)

        parts, remote = [], 0
        for combo in itertools.product(*pieces):  # row-major over the dims' pieces
            index = tuple(b for b, _, _ in combo)
            piece = self.blocks[index]
            if any(lo or hi != n for (_, lo, hi), n in zip(combo, piece.shape)):
                piece = piece[tuple(slice(lo, hi) for _, lo, hi in combo)]
            if own is not None and index != own:
                remote += piece.numel() * piece.element_size()
            parts.append(piece.to(device))
        if remote:
            note_transfer("all-gather", remote, 1)
        return _join(parts, [len(p) for p in pieces])

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first device),
        outside autograd."""
        dev = self.mesh.devices.flat[0] if device is None else torch.device(device)
        with torch.no_grad():
            return self.take(dev, [None] * self.ndim).detach()

    def copy_(self, full: torch.Tensor) -> "Sharded":
        """Write the whole tensor ``full`` into the blocks, in place."""
        with torch.no_grad():
            for index, blk in self.blocks.items():
                blk.copy_(full[_block_slices(index, self.shape, self.splits())])
        return self

    def with_blocks(self, blocks: dict) -> "Sharded":
        """A Sharded of the same layout holding ``blocks`` (by index)."""
        return Sharded(self.mesh, self.spec, self.shape, blocks)

    def __getitem__(self, g: int) -> "Sharded":
        """Entry ``g`` of a leading dimension that is not split."""
        if not isinstance(g, int) or self._dims[0]:
            raise TypeError("only an int index into a replicated leading dimension")
        return Sharded(self.mesh, Spec(*self.spec[1:]), self.shape[1:],
                       {i[1:]: b[g] for i, b in self.blocks.items()})

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, {self.spec}, "
                f"{len(self.blocks)} blocks)")


def _join(parts: list, counts: list) -> torch.Tensor:
    """Row-major ``parts`` of a grid with ``counts`` pieces along each
    dimension, concatenated into one tensor."""
    multi = [d for d, c in enumerate(counts) if c > 1]
    if len(multi) <= 1:
        return torch.cat(parts, dim=multi[0]) if multi else parts[0]
    d = multi[0]
    step = len(parts) // counts[d]
    return torch.cat([_join(parts[i * step:(i + 1) * step], [1] * (d + 1) + counts[d + 1:])
                      for i in range(counts[d])], dim=d)


def _block_slices(index, shape, splits) -> tuple:
    return tuple(slice(i * (n // k), (i + 1) * (n // k)) for i, n, k in zip(index, shape, splits))


def place_leaf(mesh, x: torch.Tensor, spec: Spec, name: str = "") -> Sharded:
    """``x`` cut into its blocks by ``spec``, each on its owner's device."""
    if len(spec) > x.ndim:
        raise ValueError(f"{name or 'leaf'}: spec {spec} has more entries than its "
                         f"{x.ndim} dimensions")
    seen: set = set()
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            if a not in mesh.axis_names:
                raise ValueError(f"{name or 'leaf'}: axis {a!r} of {spec} is not an axis of "
                                 f"the mesh {mesh.axis_names}")
            if a in seen:
                raise ValueError(f"{name or 'leaf'}: axis {a!r} appears twice in {spec}")
            seen.add(a)
    out = Sharded(mesh, Spec(*spec), x.shape, {})
    for d, (n, k) in enumerate(zip(x.shape, out.splits())):
        if n % k:
            raise ValueError(f"{name or 'leaf'}: dimension {d} of {tuple(x.shape)} does not "
                             f"divide into {k} blocks over {out._dims[d]}")
    with torch.no_grad():
        for coord in np.ndindex(mesh.devices.shape):
            index = out.index(coord)
            if index not in out.blocks:
                part = x[_block_slices(index, x.shape, out.splits())]
                out.blocks[index] = part.to(mesh.devices[coord]).clone(
                    memory_format=torch.contiguous_format)
    return out


def _map(fn, tree, specs, path=""):
    if isinstance(specs, Spec):
        return fn(tree, specs, path)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], specs[k], f"{path}{k}.") for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, getattr(tree, f), getattr(specs, f), f"{path}{f}.")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, s, f"{path}{i}.") for i, (t, s) in
                          enumerate(zip(tree, specs)))
    raise TypeError(f"{path}: no spec for a {type(tree).__name__}")


def place(mesh, tree, specs):
    """Every tensor of ``tree`` (nested dicts, lists, tuples, NamedTuples)
    cut over ``mesh`` by the ``Spec`` at the same place of ``specs``: a tree
    of ``Sharded``. Raises ValueError on a dimension that does not divide,
    naming it."""
    return _map(lambda x, s, p: place_leaf(mesh, x, s, p.rstrip(".")), tree, specs)


def gather(tree, device=None):
    """``place``'s inverse: each ``Sharded`` of ``tree`` whole on ``device``."""
    if isinstance(tree, Sharded):
        return tree.gather(device)
    if isinstance(tree, dict):
        return {k: gather(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(gather(getattr(tree, f), device) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather(v, device) for v in tree)
    return tree


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A mesh and a spec: where ``checkpoint.restore(shardings=...)`` puts a leaf."""

    mesh: Any
    spec: Spec


def to_shardings(mesh, spec_tree):
    """The spec tree with each ``Spec`` bound to ``mesh``."""
    if isinstance(spec_tree, Spec):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: to_shardings(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(to_shardings(mesh, getattr(spec_tree, f))
                                 for f in spec_tree._fields))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(to_shardings(mesh, v) for v in spec_tree)
    raise TypeError(type(spec_tree).__name__)


def coords(mesh) -> list[list[tuple]]:
    """The mesh's coordinates as [data shard][model shard]: the data shards
    row-major over the data axes (every axis but ``model``)."""
    names = mesh.axis_names
    other = [a for a in names if a != "model"]
    M = mesh.shape.get("model", 1)
    out = []
    for rest in itertools.product(*(range(mesh.shape[a]) for a in other)):
        row = []
        for j in range(M):
            pos = dict(zip(other, rest), model=j)
            row.append(tuple(pos[a] for a in names))
        out.append(row)
    return out
