"""The LM over a device mesh: tensor- and data-parallel train, prefill and
decode, and the sequence-sharded decode, under the rules of `sharding`.

The reference has no module of this name: GSPMD partitions its one-device
step by the specs and inserts the collectives. The port writes that step
out, in one process over the port's `launch.mesh.Mesh` (as the sharded
stream does): every block of a sharded tensor is its own tensor on its
coordinate's device, a mesh may repeat a device (``make_host_mesh(4, 2)``
is eight entries of ``cpu``; on one card, logical shards of ``cuda:0``),
the cross-shard sums are `launch.mesh.cross_device_sum` in shard order
(each a ``reduce.cross_device`` count), and autograd carries gradients
back through the ``.to(device)`` copies and the sums: the port's
counterpart of the reductions GSPMD inserts.

For each coordinate (data shard i, model shard j) the step builds the
namespace of j's blocks, gathered over the data axes (FSDP), and applies
to it the one-device model's own layer steps (``transformer.mixer_*`` /
``ffn_*``, ``model.token_embeds`` / ``ce_stats``); what this module adds
is where their partial outputs are summed:

  * attention: the query heads split over ``model``; each shard computes
    only the KV heads its query heads read (head h reads h // (Hp / KV)),
    runs ``flash_attention_bhsd`` on its slice (through ``FlashAttention``
    when training), masks its padded heads, and the partial outputs of
    ``wo`` are summed over ``model`` and replicated;
  * dense FFN and MoE: ``wi`` split by columns (the gate and up halves of
    a fused SwiGLU each), ``wo`` by rows, the partial outputs summed; the
    MoE router is replicated, so ``ids``, ``pos`` and ``keep`` are the same
    on every model shard. Its groups are a data shard's own: they equal the
    one-device groups when (B / D) * S is a multiple of ``GROUP_SIZE``;
    the aux loss averages its two factors over the data shards first;
  * Mamba: ``in_proj`` (its x and z halves each), the conv, ``dt_proj``,
    ``dt_bias``, ``A_log`` and ``D`` split over d_inner, ``x_proj`` and
    ``out_proj`` by rows. ``x_proj`` contracts over d_inner, so each shard's
    (dt, B, C) projection is a partial sum: the layer runs in two halves
    (``transformer.mamba_in`` / ``mamba_out``) around its sum over
    ``model``, and the partial outputs of ``out_proj`` are summed as
    attention's are. The scan, its state h and the conv window are a
    shard's own slice of d_inner;
  * RWKV6 time-mix: ``wr``, ``wk``, ``wv``, ``wg``, ``w0``, ``wB``, ``u``
    and the group norm split by heads (the query heads' slices), ``wo`` by
    rows, the partial outputs summed; the token-shift LoRA and ``wA`` stay
    whole. The recurrence, its state S and the per-head norm are local, and
    padded heads stay masked by their global index. The channel-mix splits
    ``wk`` by columns and ``wv`` by rows; each shard gates its partial
    ``wv`` output by sigmoid(r) (``wr`` whole) before the sum;
  * embed and head: split by vocab rows; each shard embeds the ids in its
    range and the results are summed; the chunked cross-entropy combines
    each shard's logsumexp and gold logit, so no shard holds all of a
    chunk's logits; prefill and decode return the whole logits on the
    mesh's first device;
  * the batch is split over the data axes, or replicated when smaller
    than the data degree; the loss is sum(masked CE) / sum(mask) over all
    rows plus the aux loss, on the first device;
  * decode with a sequence-sharded cache (a batch smaller than the data
    degree, the reference's long_500k layout): data shard i keeps positions
    [i T / D, (i + 1) T / D), the new token's k, v go to the shard that owns
    ``cache_len``, and each shard's (max, sum, accumulator) are merged on
    the first device of their model shard in shard order (flash decoding).
    The SSM states have no positions: they are replicated over the data
    shards, which all step them alike.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import Sharded
from repro_torch.launch.mesh import cross_device_sum
from repro_torch.models import attention, moe
from repro_torch.models import model as lm
from repro_torch.models import transformer as tf
from repro_torch.models.common import Policy, rms_norm
from repro_torch.optim.adamw import AdamWState

# ------------------------------------------------------------------ layout


class Grid:
    """A mesh's coordinates as [data shard i][model shard j]."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.coords = shd.coords(mesh)
        self.D, self.M = len(self.coords), len(self.coords[0])

    def dev(self, i: int, j: int) -> torch.device:
        return self.mesh.devices[self.coords[i][j]]

    def row(self, i: int) -> list[torch.device]:
        return [self.dev(i, j) for j in range(self.M)]

    def cells(self):
        for i in range(self.D):
            for j in range(self.M):
                yield i, j


def _key(name: str, index: tuple) -> str:
    return f"{name}@{','.join(map(str, index))}"


class MeshLM:
    """The LM's parameters placed on a mesh by ``sharding.param_pspecs``:
    ``params`` maps each of the port's parameter names to a `Sharded`."""

    def __init__(self, cfg: ArchConfig, mesh, params: dict[str, Sharded]):
        self.cfg, self.mesh, self.params = cfg, mesh, params
        self.grid = Grid(mesh)
        self.heads = attention.head_shards(cfg, self.grid.M)
        self._parts: dict[tuple, list] = {}  # (group, layer, part) -> [(leaf, Sharded)]
        for name, sh in params.items():
            keys = name.split(".")
            if keys[0] == "groups":
                self._parts.setdefault((int(keys[1]), keys[2], keys[3]), []).append(
                    (".".join(keys[4:]), sh))

    def leaves(self) -> dict[str, torch.Tensor]:
        """Every block, the optimizer's leaves, by ``name@index``."""
        return self.flat(self.params)

    @staticmethod
    def flat(tree: dict[str, Sharded]) -> dict[str, torch.Tensor]:
        return {_key(n, i): b for n, sh in tree.items() for i, b in sh.blocks.items()}

    def unflat(self, flat: dict[str, torch.Tensor]) -> dict[str, Sharded]:
        """``flat``'s blocks (e.g. gradients by ``name@index``) in this
        layout, one `Sharded` a parameter."""
        return {n: sh.with_blocks({i: flat[_key(n, i)] for i in sh.blocks})
                for n, sh in self.params.items()}

    def gather(self, device="cpu") -> dict[str, torch.Tensor]:
        return {n: sh.gather(device) for n, sh in self.params.items()}

    # -- per-coordinate views: the namespace of j's blocks on a device

    def _ranges(self, kind: str, leaf: str, shape, j: int) -> tuple:
        M, hs = self.grid.M, self.heads[j]
        if M == 1:
            return ()
        if kind == "attn":
            heads, kv = [(hs.h0, hs.h1)], [(hs.k0, hs.k1)]
            return {"wq": (None, heads), "wk": (None, kv), "wv": (None, kv), "wo": (heads,),
                    "bq": (heads,), "bk": (kv,), "bv": (kv,)}.get(leaf, ())
        if kind == "mamba":
            di = self.cfg.ssm_d_inner
            s = di // M
            r = [(j * s, (j + 1) * s)]
            if leaf == "in_proj":  # the x half and the z half
                return (None, r + [(di + j * s, di + (j + 1) * s)])
            return {"conv_w": (None, r), "dt_proj": (None, r)}.get(leaf, (r,))
        if kind == "rwkv6":
            a = [(hs.h0 * self.cfg.rwkv_head_size, hs.h1 * self.cfg.rwkv_head_size)]
            cols = {"wr", "wk", "wv", "wg", "wB"}
            rows = {"w0": a, "ln_scale": a, "ln_bias": a, "wo": a, "u": [(hs.h0, hs.h1)]}
            return (None, a) if leaf in cols else ((rows[leaf],) if leaf in rows else ())
        if kind == "rwkv_cmix":
            s = self.cfg.d_ff // M
            r = [(j * s, (j + 1) * s)]
            return {"wk": (None, r), "wv": (r,)}.get(leaf, ())
        nd = len(shape)
        if leaf in ("wi", "shared_wi"):
            W = shape[-1]
            fused = not (kind == "dense" and self.cfg.act != "swiglu")
            half = W // 2 if fused else W
            if half % M:
                raise ValueError(f"{leaf}: width {half} does not split over {M} model shards")
            s = half // M
            cols = [(j * s, (j + 1) * s)] + ([(half + j * s, half + (j + 1) * s)] if fused else [])
            return (None,) * (nd - 1) + (cols,)
        if leaf in ("wo", "shared_wo"):
            s = shape[-2] // M
            return (None,) * (nd - 2) + ([(j * s, (j + 1) * s)],)
        return ()  # router, shared_gate

    def _vocab(self, j: int) -> tuple[int, int]:
        s = self.cfg.vocab_size // self.grid.M
        return j * s, (j + 1) * s

    def top_view(self, i: int, j: int) -> SimpleNamespace:
        """Coordinate (i, j)'s embed (and head) rows / columns of j's vocab
        range and final_norm, on its device."""
        vr = [self._vocab(j)] if self.grid.M > 1 else None
        dev, at = self.grid.dev(i, j), self.grid.coords[i][j]
        emb = self.params["embed"]
        out = SimpleNamespace(
            embed=emb.take(dev, (None, vr) if emb.ndim == 3 else (vr,), at),
            final_norm=self.params["final_norm"].take(dev, (), at))
        if "head" in self.params:
            head = self.params["head"]
            out.head = head.take(dev, (None, None, vr) if head.ndim == 3 else (None, vr), at)
        return out

    def group_view(self, g: int, i: int, j: int) -> SimpleNamespace:
        """Group g's layers as coordinate (i, j) holds them, on its device:
        model shard j's slices, gathered over the data axes (FSDP)."""
        dev, at = self.grid.dev(i, j), self.grid.coords[i][j]
        group = SimpleNamespace()
        for li, spec in enumerate(self.cfg.layer_pattern()):
            pre = f"groups.{g}.layer{li}."
            lp = SimpleNamespace(norm1=self.params[pre + "norm1"].take(dev, (), at),
                                 norm2=self.params[pre + "norm2"].take(dev, (), at),
                                 mixer=SimpleNamespace(), ffn=SimpleNamespace())
            kinds = {"mixer": spec.mixer, "ffn": spec.ffn}
            for part, kind in kinds.items():
                for leaf, sh in self._parts.get((g, f"layer{li}", part), []):
                    setattr(getattr(lp, part), leaf,
                            sh.take(dev, self._ranges(kind, leaf, sh.shape, j), at))
            setattr(group, f"layer{li}", lp)
        return group


def shard_model(mesh, model) -> MeshLM:
    """The one-device LM ``model`` placed on ``mesh`` by ``param_pspecs``."""
    cfg = model.cfg
    named = dict(model.named_parameters())
    return MeshLM(cfg, mesh, shd.place(mesh, named, shd.param_pspecs(cfg, named)))


def shard_opt_state(params: MeshLM, state: AdamWState) -> AdamWState:
    """A one-device AdamW state's moments placed like the parameters (ZeRO)."""
    specs = {n: sh.spec for n, sh in params.params.items()}
    return AdamWState(state.step, shd.place(params.mesh, state.mu, specs),
                      shd.place(params.mesh, state.nu, specs))


# ------------------------------------------------------------------ batch


def _batch_blocks(grid: Grid, batch: dict, replicate: bool = False) -> tuple[list, bool]:
    """The batch's rows of each data shard on each coordinate's device:
    [i][j] -> dict, and whether every data shard holds the whole batch."""
    B = next(iter(batch.values())).shape[0]
    rep = replicate or B < grid.D
    out = [[{} for _ in range(grid.M)] for _ in range(grid.D)]
    for k, v in batch.items():
        spec = shd.Spec(*([None] * v.ndim)) if rep else shd.batch_spec(grid.mesh, B, v.ndim)
        sh = shd.place_leaf(grid.mesh, v, spec, k)
        for i, j in grid.cells():
            out[i][j][k] = sh.block(grid.coords[i][j])
    return out, rep


def _embed(p: MeshLM, policy: Policy, bs: list, tops: list) -> list:
    """``model.embed_inputs`` over the mesh: [i][j] -> x (B_i, S, d) on each
    coordinate, the token embeddings summed over the vocab shards."""
    cfg, grid = p.cfg, p.grid
    xs = []
    for i in range(grid.D):
        parts = [lm.token_embeds(policy.cast(tops[i][j].embed), cfg, bs[i][j], p._vocab(j)[0])
                 for j in range(grid.M)]
        x = lm.frontend(cfg, policy, bs[i][0], cross_device_sum(parts, grid.row(i)))
        xs.append([x.to(d) for d in grid.row(i)])
    return xs


def _add_sum(grid: Grid, xs: list, ys: list) -> list:
    """x += the sum over model shards of the partial outputs ys, per data shard."""
    tot = _sum_over_model(grid, ys)
    return [[xs[i][j] + tot[i][j] for j in range(grid.M)] for i in range(grid.D)]


def _firsts(outs: list) -> list:
    return [[o[0] for o in row] for row in outs]


def _moe_aux(grid: Grid, cfg, stats: list) -> torch.Tensor:
    """The aux loss of the whole batch from each data shard's (frac, mean_p):
    the mean over shards of equal token counts, then the product."""
    frac, mean_p = cross_device_sum(stats, [grid.dev(i, 0) for i in range(grid.D)])
    return moe.aux_loss(cfg, frac / grid.D, mean_p / grid.D)


def _views(p: MeshLM, g: int) -> list:
    """Group g's layers on each coordinate's blocks: [layer][i][j]."""
    groups = [[p.group_view(g, i, j) for j in range(p.grid.M)]
              for i in range(p.grid.D)]
    return [[[getattr(v, f"layer{li}") for v in row] for row in groups]
            for li in range(len(p.cfg.layer_pattern()))]


# ------------------------------------------------------------------ training


def _sum_over_model(grid: Grid, ys: list) -> list:
    """The sum over model shards of the partial outputs ys, per data shard,
    on every coordinate: [i][j]."""
    out = []
    for i in range(grid.D):
        tot = cross_device_sum(ys[i], grid.row(i))
        out.append([tot.to(grid.dev(i, j)) for j in range(grid.M)])
    return out


def _mixers(p: MeshLM, policy: Policy, spec, lps: list, xs: list, *, positions=None,
            prefill: bool = False, caches=None, cache_len: int = 0) -> list:
    """Each coordinate's mixer: [i][j] -> (partial delta, its cache or None),
    the training step (``positions``), prefill (``prefill``) or one decode
    step (``caches``). A Mamba layer runs in two halves around the sum over
    ``model`` of its ``x_proj`` output."""
    cfg, grid = p.cfg, p.grid
    rows, cols = range(grid.D), range(grid.M)
    if spec.mixer == "mamba":
        c = [[None if caches is None else caches[i][j] for j in cols] for i in rows]
        ins = [[tf.mamba_in(lps[i][j], cfg, policy, xs[i][j], c[i][j]) for j in cols]
               for i in rows]
        proj = _sum_over_model(grid, [[pr for _, pr in row] for row in ins])
        return [[tf.mamba_out(lps[i][j], cfg, policy, ins[i][j][0], proj[i][j], c[i][j])
                 for j in cols] for i in rows]
    if caches is not None:
        return [[tf.mixer_decode(lps[i][j], spec, cfg, policy, xs[i][j], caches[i][j],
                                 cache_len, p.heads[j]) for j in cols] for i in rows]
    if prefill:
        return [[tf.mixer_prefill(lps[i][j], spec, cfg, policy, xs[i][j], positions[i][j],
                                  p.heads[j]) for j in cols] for i in rows]
    return [[(tf.mixer_full(lps[i][j], spec, cfg, policy, xs[i][j], positions[i][j],
                            p.heads[j]), None) for j in cols] for i in rows]


def _group_full(p: MeshLM, policy: Policy, g: int, xs: list, positions: list):
    cfg, grid = p.cfg, p.grid
    aux = torch.zeros((), dtype=torch.float32, device=grid.dev(0, 0))
    for spec, lps in zip(cfg.layer_pattern(), _views(p, g)):
        xs = _add_sum(grid, xs, _firsts(_mixers(p, policy, spec, lps, xs, positions=positions)))
        outs = [[tf.ffn_full(lps[i][j], spec, cfg, policy, xs[i][j]) for j in range(grid.M)]
                for i in range(grid.D)]
        xs = _add_sum(grid, xs, _firsts(outs))
        if spec.ffn == "moe":
            aux = aux + _moe_aux(grid, cfg, [outs[i][0][1] for i in range(grid.D)])
    return xs, aux


def _chunked_ce(p: MeshLM, policy: Policy, xs: list, bs: list, tops: list) -> torch.Tensor:
    """``model._chunked_ce`` over the mesh: per data shard and chunk, each
    vocab shard's (logsumexp, gold logit) under ``checkpoint``, combined on
    the data shard's first device, so no shard holds all of a chunk's
    logits; the sums of masked CE and of the mask over data shards on the
    first device."""
    cfg, grid = p.cfg, p.grid
    totals = []
    for i in range(grid.D):
        dev, b = grid.dev(i, 0), bs[i][0]
        B, S = xs[i][0].shape[:2]
        mask = b.get("loss_mask")
        mask = (torch.ones((B, S), device=dev) if mask is None else mask).to(torch.float32)

        def stats(c0, c1, y, i=i, dev=dev):
            parts = [checkpoint(lm.ce_stats, tops[i][j], cfg, policy, xs[i][j][:, c0:c1],
                                y.to(grid.dev(i, j)), p._vocab(j)[0], use_reentrant=False)
                     for j in range(grid.M)]
            lse = torch.logsumexp(torch.stack([l.to(dev) for l, _ in parts]), dim=0)
            return lse, cross_device_sum([g for _, g in parts], grid.row(i))

        totals.append(lm.ce_sums(cfg, lm._labels(cfg, b), mask, stats))
    tot, cnt = cross_device_sum(totals, [grid.dev(i, 0) for i in range(grid.D)])
    return tot / torch.clamp(cnt, min=1.0)


def _final(p: MeshLM, xs: list, tops: list) -> list:
    return [[rms_norm(xs[i][j], tops[i][j].final_norm, p.cfg.norm_eps)
             for j in range(p.grid.M)] for i in range(p.grid.D)]


def _tops(p: MeshLM) -> list:
    return [[p.top_view(i, j) for j in range(p.grid.M)] for i in range(p.grid.D)]


def _positions(grid: Grid, xs: list) -> list:
    return [[torch.arange(x.shape[1], device=x.device).expand(x.shape[0], x.shape[1])
             for x in row] for row in xs]


def forward_train(p: MeshLM, policy: Policy, batch: dict) -> tuple[torch.Tensor, dict]:
    """``model.forward_train`` over the mesh: (loss, {"ce", "aux"}) on the
    mesh's first device, differentiable in the blocks that require grad.
    With ``cfg.remat == "full"`` each group runs under ``checkpoint`` (its
    gathers and cross-device sums recomputed in the backward)."""
    cfg, grid = p.cfg, p.grid
    bs, _ = _batch_blocks(grid, batch)
    tops = _tops(p)
    xs = _embed(p, policy, bs, tops)
    positions = _positions(grid, xs)
    aux = torch.zeros((), dtype=torch.float32, device=grid.dev(0, 0))
    n = grid.D * grid.M
    for g in range(cfg.num_groups):
        if cfg.remat == "full":
            def run(*flat, g=g):
                rows = [list(flat[i * grid.M:(i + 1) * grid.M]) for i in range(grid.D)]
                out, a = _group_full(p, policy, g, rows, positions)
                return (*[x for row in out for x in row], a)

            res = checkpoint(run, *[x for row in xs for x in row], use_reentrant=False)
            xs = [list(res[i * grid.M:(i + 1) * grid.M]) for i in range(grid.D)]
            aux_g = res[n]
        else:
            xs, aux_g = _group_full(p, policy, g, xs, positions)
        aux = aux + aux_g
    ce = _chunked_ce(p, policy, _final(p, xs, tops), bs, tops)
    return ce + aux, {"ce": ce, "aux": aux}


# ------------------------------------------------------------------ serving


@dataclasses.dataclass(eq=False)
class MeshCache:
    """The decode cache over a mesh: ``shards[i][j]`` is coordinate (i, j)'s
    cache, the port's list of one dict a group, holding data shard i's
    rows (all of them when ``replicated``), the KV heads model shard j's
    query heads read and, when ``seq_sharded``, positions
    [i T / D, (i + 1) T / D) only."""

    shards: list
    replicated: bool = False
    seq_sharded: bool = False

    def map(self, fn) -> "MeshCache":
        """``fn`` applied to each coordinate's cache list."""
        return MeshCache([[fn(c) for c in row] for row in self.shards], self.replicated,
                         self.seq_sharded)

    def seq_split(self) -> "MeshCache":
        """A replicated cache cut over its positions (each data shard keeps
        its T / D): the sequence-sharded layout of a batch smaller than the
        data degree. Any other cache is returned as it is."""
        D = len(self.shards)
        if not self.replicated or self.seq_sharded or D == 1:
            return self

        def cut(i: int, name: str, x: torch.Tensor) -> torch.Tensor:
            if name not in ("k", "v", "k_scale", "v_scale"):
                return x  # an SSM state: no positions
            T = x.shape[1]
            if T % D:
                raise ValueError(f"cache length {T} does not split over {D} data shards")
            return x[:, i * (T // D):(i + 1) * (T // D)].clone()

        return MeshCache([[[{layer: {n: cut(i, n, x) for n, x in st.items()}
                             for layer, st in g.items()} for g in c] for c in row]
                          for i, row in enumerate(self.shards)], True, True)


def place_cache(p: MeshLM, cache: list, seq_shard: bool) -> MeshCache:
    """A one-device cache placed by ``sharding.cache_specs``: the batch
    split (or, with ``seq_shard``, the positions of k / v and their int8
    scales split and the batch replicated) over the data axes, and each
    model shard's attention caches narrowed to the KV heads it reads (a
    local slice of the KV dimension the specs replicate)."""
    grid = p.grid
    sh = shd.place(grid.mesh, cache, shd.cache_specs(grid.mesh, cache, seq_shard))
    attn = {f"layer{li}" for li, spec in enumerate(p.cfg.layer_pattern()) if spec.mixer == "attn"}

    def local(i: int, j: int, layer: str, s: Sharded) -> torch.Tensor:
        x = s.block(grid.coords[i][j])
        if layer in attn and grid.M > 1:  # k, v and their int8 scales: dim 2 is KV
            x = x[:, :, p.heads[j].k0:p.heads[j].k1].contiguous()
        return x

    shards = [[[{layer: {n: local(i, j, layer, s) for n, s in st.items()}
                 for layer, st in g.items()} for g in sh]
               for j in range(grid.M)] for i in range(grid.D)]
    return MeshCache(shards, seq_shard, seq_shard)


def _group_prefill(p: MeshLM, policy: Policy, g: int, xs: list, positions: list):
    cfg, grid = p.cfg, p.grid
    caches = [[{} for _ in range(grid.M)] for _ in range(grid.D)]
    for li, (spec, lps) in enumerate(zip(cfg.layer_pattern(), _views(p, g))):
        outs = _mixers(p, policy, spec, lps, xs, positions=positions, prefill=True)
        xs = _add_sum(grid, xs, _firsts(outs))
        ys = [[tf.ffn_full(lps[i][j], spec, cfg, policy, xs[i][j])[0] for j in range(grid.M)]
              for i in range(grid.D)]
        for i, j in grid.cells():
            c = outs[i][j][1]
            tf.cmix_state(lps[i][j], spec, cfg, xs[i][j], c)
            caches[i][j][f"layer{li}"] = c
        xs = _add_sum(grid, xs, ys)
    return xs, caches


def _gather_logits(grid: Grid, parts: list, replicated: bool) -> torch.Tensor:
    dev0 = grid.dev(0, 0)
    rows = []
    for i in range(1 if replicated else grid.D):
        pj = [x.to(dev0) for x in parts[i]]
        rows.append(pj[0] if grid.M == 1 else torch.cat(pj, dim=-1))
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)


def _logits(p: MeshLM, policy: Policy, xs: list, tops: list, replicated: bool):
    cfg = p.cfg
    xs = _final(p, xs, tops)
    parts = [[lm._last(cfg, lm._head_logits(tops[i][j], cfg, policy, xs[i][j][:, -1:]))
              for j in range(p.grid.M)] for i in range(p.grid.D)]
    return _gather_logits(p.grid, parts, replicated)


def forward_prefill(p: MeshLM, policy: Policy, batch: dict) -> tuple[torch.Tensor, MeshCache]:
    """``model.forward_prefill`` over the mesh: (last-position logits (B, V),
    or (B, K, V), whole on the mesh's first device, the `MeshCache`)."""
    cfg, grid = p.cfg, p.grid
    bs, rep = _batch_blocks(grid, batch)
    tops = _tops(p)
    xs = _embed(p, policy, bs, tops)
    positions = _positions(grid, xs)
    shards = [[[] for _ in range(grid.M)] for _ in range(grid.D)]
    for g in range(cfg.num_groups):
        xs, caches = _group_prefill(p, policy, g, xs, positions)
        for i, j in grid.cells():
            shards[i][j].append(caches[i][j])
    return _logits(p, policy, xs, tops, rep), MeshCache(shards, rep, False)


def _decode_partial(a, cfg, policy, h, c, cache_len, heads: attention.Heads, i: int):
    """A data shard's part of the sequence-sharded decode: write the new
    token if this shard owns ``cache_len``, then (m, l, acc) over its live
    positions."""
    q, k_new, v_new = attention.decode_qkv(a, cfg, policy, h, cache_len)
    T = c["k"].shape[1]
    off = i * T
    if off <= cache_len < off + T:
        attention.cache_write(c, cache_len - off, k_new, v_new)
    lo, hi = attention.live_range(cfg, cache_len)
    a0, a1 = max(lo, off) - off, min(hi, off + T) - off
    k_c, v_c = attention.cache_read(c, slice(a0, max(a0, a1)), policy)
    return attention.decode_partial(q, attention._kv_per_head(policy.cast(k_c), cfg, heads),
                                    attention._kv_per_head(policy.cast(v_c), cfg, heads))


def _merge(grid: Grid, j: int, parts: list) -> torch.Tensor:
    """The flash-decode merge of model shard j's (m, l, acc) over the data
    shards, in shard order, on coordinate (0, j): out (B, 1, Hs, Dh) f32."""
    devs = [grid.dev(i, j) for i in range(grid.D)]
    m = torch.amax(torch.stack([m_i.to(devs[0]) for m_i, _, _ in parts]), dim=0)
    scaled = []
    for (m_i, l_i, acc_i), dev in zip(parts, devs):
        w = torch.exp(m_i - m.to(dev))
        scaled.append((l_i * w, acc_i * w[..., None]))
    l, acc = cross_device_sum(scaled, devs)
    return (acc / torch.clamp(l, min=1e-30)[..., None])[:, None]


def _seq_sharded_attn(p: MeshLM, policy: Policy, lps: list, xs: list, caches: list,
                      cache_len: int) -> list:
    """The attention layer of the sequence-sharded decode: each model shard's
    heads merged over the data shards on row 0, its out-projection there,
    the sum over model shards added on every coordinate."""
    cfg, grid = p.cfg, p.grid
    ys = []
    for j in range(grid.M):
        parts = []
        for i in range(grid.D):
            h = rms_norm(xs[i][j], lps[i][j].norm1, cfg.norm_eps)
            parts.append(_decode_partial(lps[i][j].mixer, cfg, policy, h, caches[i][j],
                                         cache_len, p.heads[j], i))
        out = _merge(grid, j, parts).to(xs[0][j].dtype)
        ys.append(attention.attend_out(lps[0][j].mixer, cfg, policy, out, p.heads[j]))
    tot = cross_device_sum(ys, grid.row(0))
    return [[xs[i][j] + tot.to(grid.dev(i, j)) for j in range(grid.M)] for i in range(grid.D)]


def _group_decode(p: MeshLM, policy: Policy, g: int, xs: list, mc: MeshCache, cache_len: int):
    cfg, grid = p.cfg, p.grid
    for li, (spec, lps) in enumerate(zip(cfg.layer_pattern(), _views(p, g))):
        name = f"layer{li}"
        caches = [[mc.shards[i][j][g][name] for j in range(grid.M)] for i in range(grid.D)]
        if spec.mixer == "attn" and mc.seq_sharded:
            xs = _seq_sharded_attn(p, policy, lps, xs, caches, cache_len)
        else:
            outs = _mixers(p, policy, spec, lps, xs, caches=caches, cache_len=cache_len)
            caches = [[o[1] for o in row] for row in outs]
            xs = _add_sum(grid, xs, _firsts(outs))
        outs = [[tf.ffn_decode(lps[i][j], spec, cfg, policy, xs[i][j], caches[i][j])
                 for j in range(grid.M)] for i in range(grid.D)]
        for i, j in grid.cells():
            mc.shards[i][j][g][name] = outs[i][j][1]
        xs = _add_sum(grid, xs, _firsts(outs))
    return xs


def forward_decode(p: MeshLM, policy: Policy, batch: dict, mc: MeshCache,
                   cache_len: int) -> tuple[torch.Tensor, MeshCache]:
    """``model.forward_decode`` over the mesh: one token a sequence written
    into the cache at ``cache_len`` (in place; the SSM states replaced).
    Returns (logits (B, V) or (B, K, V) on the mesh's first device, cache)."""
    cfg, grid = p.cfg, p.grid
    bs, _ = _batch_blocks(grid, batch, replicate=mc.replicated)
    tops = _tops(p)
    xs = [[lm.at_position(cfg, x, cache_len) for x in row] for row in _embed(p, policy, bs, tops)]
    for g in range(cfg.num_groups):
        xs = _group_decode(p, policy, g, xs, mc, cache_len)
    return _logits(p, policy, xs, tops, mc.replicated), mc
