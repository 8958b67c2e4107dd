"""Public wrappers over the hand-written kernels, the block maps of the stream
engine, the Lloyd step plan, and the LM's attention.

The CUDA kernels mask ragged edges themselves, so nothing here pads: there
are no lane-multiple copies of X, no sentinel centroid rows and no padded
[cos | 0 | sin | 0] relayout of RFF centroids. Routing follows
``ComputePolicy.resolve_kernels``: by default CUDA tensors reach the kernels
and CPU tensors their plain PyTorch versions; ``kernels=False`` takes the
plain versions on the card too.
"""
from __future__ import annotations

import warnings
from functools import wraps

import torch

from repro_torch import obs
from repro_torch.core.apnc import APNCCoefficients
from repro_torch.embed.rff import RFFParams
from repro_torch.kernels import apnc_assign as _assign
from repro_torch.kernels import apnc_embed as _embed
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import lloyd_step as _lloyd_step
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rff_embed as _rff
from repro_torch.policy import ComputePolicy, as_policy
from repro_torch.stream.blockstore import EncodedBlock


def apnc_embed(X: torch.Tensor, coeffs: APNCCoefficients) -> torch.Tensor:
    """Fused APNC embedding over all q blocks: X (n, d) -> Y (n, q * m_b) f32.
    Each block's kernel writes straight into its column slice of Y."""
    n = X.shape[0]
    m_b = coeffs.R.shape[1]
    Y = torch.empty((n, coeffs.q * m_b), dtype=torch.float32, device=X.device)
    landmarks = coeffs.landmarks.to(torch.float32)
    R = coeffs.R.to(torch.float32)
    X = X.contiguous()
    for b in range(coeffs.q):
        _embed.apnc_embed_block(
            X, landmarks[b].contiguous(), R[b].contiguous(), coeffs.kernel,
            out=Y[:, b * m_b:(b + 1) * m_b],
        )
    return Y


def apnc_assign(
    Y: torch.Tensor, C: torch.Tensor, discrepancy: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused assignment + sufficient stats: Y (n, m), C (k, m) -> Z (k, m) f32,
    g (k,) f32, labels (n,) int32."""
    return _assign.apnc_assign(
        Y.to(torch.float32).contiguous(), C.to(torch.float32).contiguous(), discrepancy
    )


def rff_embed(X: torch.Tensor, params) -> torch.Tensor:
    """The rff member's map through its kernel: X (n, d) -> Y (n, 2 m_half) f32
    in the [cos, sin] layout."""
    return _rff.rff_embed_block(
        X.to(torch.float32).contiguous(), params.W.to(torch.float32).contiguous(),
        params.scale,
    )


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Causal (+ sliding window) attention over flat heads: q (B, S, H, Dh),
    k, v (B, S, Hkv, Dh) with H a multiple of Hkv (grouped KV heads: query
    head h reads KV head h // (H // Hkv), with no repeated copy) ->
    (B, S, H, Dh).

    On a CUDA tensor the hand-written ``flash_attention_bhsd`` kernel, on a
    CPU tensor its plain version ``ref.flash_attention_ref`` (under autograd
    when an input requires grad). On a card under grad mode with an input
    that requires grad, the kernel through its ``autograd.Function``, whose
    backward recomputes the attention in ``torch`` ops. Limits, on both: all
    float32 or all bfloat16, 1 <= Dh <= 256, the head dim contiguous;
    outside them it raises. Positions are the row indices. ``meta`` tensors
    (the dry-run) take the card's route, the launch replaced by the op that
    counts it (``flash_attention.causal_pairs``).
    """
    if (q.device.type in ("cuda", "meta") and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return _flash.flash_attention(q, k, v, window=window)
    return _flash.flash_attention_bhsd(q, k, v, window=window)


def embed_block_map(x: torch.Tensor, params, *, policy: ComputePolicy | None = None):
    """Block-shaped embedding entry: one routed transform of a (rows, d) block
    for any registered embedding's params."""
    from repro_torch import embed  # the one routing point for every member

    return embed.transform(params, x, as_policy(policy))


def embed_assign_block(x: torch.Tensor, params, centroids: torch.Tensor, *,
                       policy: ComputePolicy | None = None):
    """Embed a raw (rows, d) block (any registered member) and reduce it to
    (Z, g, labels) against ``centroids``: the un-fused kernel chain."""
    from repro_torch.core.lloyd import assign_stats

    y = embed_block_map(x, params, policy=policy)
    return assign_stats(y, centroids, centroids.shape[0], params.discrepancy, policy)


def embed_assign_block_cost(x: torch.Tensor, params, centroids: torch.Tensor, *,
                            policy: ComputePolicy | None = None):
    """``embed_assign_block`` plus the block's inertia contribution under the
    same centroids: (Z, g, labels, cost)."""
    y = embed_block_map(x, params, policy=policy)
    return _assign_stats_cost_y(y, centroids, params.discrepancy, policy)


def assign_labels(y: torch.Tensor, centroids: torch.Tensor, discrepancy: str,
                  policy: ComputePolicy | None = None) -> torch.Tensor:
    """Nearest-centroid labels of embedded rows, (n,) int64: the assignment of
    ``predict_block`` and ``core.kkmeans.predict``.

    Where ``policy.resolve_kernels`` says the kernels (by default on a card),
    the labels of one ``apnc_assign`` launch: each row's distances are its
    own f32 chain, whatever the launch's row count, so a 256-row serving
    micro-batch gets the labels that a replay of the whole request log gets.
    The plain ``assign`` takes ``Y @ Cᵀ`` in cuBLAS, which may sum in another
    order at another row count: on an H100 the distance bits of every row
    differed between the two, and a near tie flipped a served label.
    Otherwise the plain ``assign`` (a CPU tensor, ``kernels=False``)."""
    if as_policy(policy).resolve_kernels(y.device):
        _, _, labels = _assign.apnc_assign(y.to(torch.float32).contiguous(),
                                           centroids.to(torch.float32).contiguous(),
                                           discrepancy)
        return labels.long()
    from repro_torch.core.apnc import assign

    return assign(y, centroids, discrepancy)


def predict_block(x: torch.Tensor, params, centroids: torch.Tensor, *,
                  policy: ComputePolicy | None = None) -> torch.Tensor:
    """Labels only, for serving: embed + nearest centroid (`assign_labels`),
    without the (Z, g) sufficient statistics the training maps build."""
    return assign_labels(embed_block_map(x, params, policy=policy), centroids,
                         params.discrepancy, policy)


# ---------------------------------------------------------------------------
# Fused Lloyd step
# ---------------------------------------------------------------------------


def fused_member(params) -> str | None:
    """Which fused Lloyd-step kernel serves these params, if any.

    "apnc" for q = 1 Nystrom/SD and "rff" for the rff member, each while the
    embedding width m (rff: 2 * m_half) is at most ``lloyd_step.MAX_M``
    (512): the kernel holds a (32 x m) Y tile in shared memory. Anything else
    (q > 1 APNC, wider m, members without a fused kernel) returns None, and
    the plan runs the un-fused kernels (the member's embedding, then
    ``apnc_assign``).
    """
    if isinstance(params, APNCCoefficients):
        return "apnc" if params.q == 1 and params.m <= _lloyd_step.MAX_M else None
    if isinstance(params, RFFParams):
        return "rff" if params.m <= _lloyd_step.MAX_M else None
    return None


def fused_lloyd_step(x: torch.Tensor, params, centroids: torch.Tensor):
    """One launch for a whole Lloyd block step: embed the raw block, assign,
    and reduce to (Z, g, labels, cost) without Y in device memory. Only valid
    when ``fused_member(params)`` is not None."""
    member = fused_member(params)
    x = x.to(torch.float32).contiguous()
    C = centroids.to(torch.float32).contiguous()
    if member == "apnc":
        return _lloyd_step.fused_apnc_step(
            x, params.landmarks[0].contiguous(), params.R[0].contiguous(), C,
            params.kernel, params.discrepancy,
        )
    if member == "rff":
        return _lloyd_step.fused_rff_step(
            x, params.W.contiguous(), C, params.scale, params.discrepancy,
        )
    raise ValueError(f"no fused Lloyd step for params of type {type(params).__name__}")


def _assign_stats_cost_y(y: torch.Tensor, centroids: torch.Tensor, discrepancy: str,
                         policy: ComputePolicy | None = None):
    """(Z, g, labels, cost) of an embedded block: where ``policy.resolve_kernels``
    says the kernels, one ``apnc_assign_step`` launch, the cost included;
    otherwise the plain ``assign_stats`` and ``block_cost``."""
    from repro_torch.core.lloyd import assign_stats, block_cost

    if as_policy(policy).resolve_kernels(y.device):
        return _assign.apnc_assign_step(y.to(torch.float32).contiguous(),
                                        centroids.to(torch.float32).contiguous(), discrepancy)
    Z, g, labels = assign_stats(y, centroids, centroids.shape[0], discrepancy, policy)
    return Z, g, labels, block_cost(y, centroids, discrepancy)


def dequant_step(block: EncodedBlock, centroids: torch.Tensor, discrepancy: str,
                 policy: ComputePolicy | None = None):
    """(Z, g, labels, cost) of one quantized cache block (int8 or bf16 payload
    and its scale). Where ``policy.resolve_kernels`` says the kernels (by
    default on a card) the route follows the shapes: ``fused_dequant_step``
    for m <= ``lloyd_step.DEQUANT_MAX_M`` (800: the decoded (32 x m) tile
    lives in shared memory), wider blocks through the ``dequant_decode``
    kernel into device memory and then ``apnc_assign_step``. Otherwise the plain
    version on the payload's device, which decodes the same way."""
    payload, scale = block
    C = centroids.to(torch.float32).contiguous()
    if not as_policy(policy).resolve_kernels(payload.device):
        return _ref.fused_dequant_step_ref(payload, scale, C, discrepancy)
    if payload.shape[1] > _lloyd_step.DEQUANT_MAX_M:
        return _assign_stats_cost_y(_lloyd_step.dequant_decode(payload, scale), C, discrepancy)
    return _lloyd_step.fused_dequant_step(payload, scale, C, discrepancy)


class LloydStepPlan:
    """One Lloyd block step, resolved once and shared by the drivers.

        step(block, centroids)   -> (Z, g, labels, cost)   # stats convention
        assign(block, centroids) -> (labels, cost)          # final-pass form

    ``block`` is a raw (rows, d) block when the plan carries embedding params
    (X-mode: the stream backends), or an already-embedded (rows, m) block when
    built with ``params=None, discrepancy=...`` (Y-mode: the local backend and
    staged embeddings), where it may also be an ``EncodedBlock``, the wire
    form of a quantized cache block. Routing, decided from the params and,
    for an encoded block, its shape:

      * X-mode, ``fused_member(params)`` not None: the fused kernel
        (``fused_apnc_step`` or ``fused_rff_step``), one launch a block;
      * X-mode otherwise: the member's embedding, then ``apnc_assign_step``
        (one launch, the block's cost included);
      * Y-mode: ``apnc_assign_step``;
      * Y-mode over an ``EncodedBlock``: ``dequant_step`` (the fused
        ``fused_dequant_step`` kernel up to m = 800).

    Each kernel runs where ``policy.resolve_kernels`` says (by default on
    CUDA blocks) and its plain version elsewhere (for ``apnc_assign_step``,
    ``assign_stats`` and ``block_cost``); ``kernels=False`` also
    drops the fused route, as the JAX package's plan does without Pallas.
    ``block_map(cell)`` / ``assign_map(cell)`` close over a 1-element
    centroids cell for the stream engine, so drivers swap centroids between
    blocks or iterations.
    """

    def __init__(self, *, params, discrepancy: str, member: str | None,
                 policy: ComputePolicy | None = None):
        self.params = params
        self.discrepancy = discrepancy
        self.fused_member = member
        self.policy = as_policy(policy)

    @property
    def fused(self) -> bool:
        return self.fused_member is not None

    def step(self, block: torch.Tensor, centroids: torch.Tensor):
        """(Z, g, labels, cost) for one block under ``centroids``."""
        pol = self.policy
        if self.params is None:
            if isinstance(block, EncodedBlock):
                return dequant_step(block, centroids, self.discrepancy, pol)
            return _assign_stats_cost_y(block, centroids, self.discrepancy, pol)
        if self.fused:
            pol.resolve_kernels(block.device)  # kernels=True raises off the card
            return fused_lloyd_step(block, self.params, centroids)
        return embed_assign_block_cost(block, self.params, centroids, policy=pol)

    def assign(self, block: torch.Tensor, centroids: torch.Tensor):
        """(labels, cost) for one block: the final / scoring pass."""
        _, _, labels, cost = self.step(block, centroids)
        return labels, cost

    def _instrumented(self, fn):
        """On the fused route, each block's step in one ``lloyd.fused_step``
        span (host time: the launch is queued, not waited for) and one
        ``engine.fused_dispatches``."""
        if not self.fused:
            return fn
        fused_dispatches = obs.counter("engine.fused_dispatches")

        def wrapped(block):
            with obs.span("lloyd.fused_step", cat="lloyd", member=self.fused_member):
                out = fn(block)
            fused_dispatches.inc()
            return out

        return wrapped

    def block_map(self, centroids_cell: list):
        """Per-block stats map for the stream engine (labels at index 2,
        cost at 3)."""
        return self._instrumented(lambda block: self.step(block, centroids_cell[0]))

    def assign_map(self, centroids_cell: list):
        """Per-block final-pass map: (labels, cost), labels at index 0."""
        return self._instrumented(lambda block: self.assign(block, centroids_cell[0]))


def lloyd_step_plan(params=None, discrepancy: str | None = None, *,
                    policy: ComputePolicy | None = None) -> LloydStepPlan:
    """Build the plan. Pass embedding ``params`` for X-mode (raw blocks), or
    ``params=None`` with an explicit ``discrepancy`` for Y-mode (embedded
    blocks). ``policy.kernels=False`` resolves to the un-fused plain route."""
    pol = as_policy(policy)
    if params is None:
        if discrepancy is None:
            raise ValueError("Y-mode plan (params=None) needs discrepancy=")
        return LloydStepPlan(params=None, discrepancy=discrepancy, member=None, policy=pol)
    member = fused_member(params) if pol.kernels is not False else None
    return LloydStepPlan(params=params, discrepancy=params.discrepancy, member=member,
                         policy=pol)


def _deprecated_alias(name: str, replacement: str, fn):
    @wraps(fn)
    def wrapper(*args, **kwargs):
        warnings.warn(
            f"ops.{name} is deprecated; use ops.{replacement} instead",
            DeprecationWarning, stacklevel=2,
        )
        return fn(*args, **kwargs)

    return wrapper


# Legacy names from when APNC was the only family member: warning shims over
# the same functions (they delegate without touching the arguments).
apnc_embed_block_map = _deprecated_alias(
    "apnc_embed_block_map", "embed_block_map", embed_block_map
)
apnc_embed_assign_block = _deprecated_alias(
    "apnc_embed_assign_block", "embed_assign_block", embed_assign_block
)
apnc_predict_block = _deprecated_alias(
    "apnc_predict_block", "predict_block", predict_block
)
