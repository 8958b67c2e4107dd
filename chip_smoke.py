"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py                    # the card: build, parity, main path, timing
    python3 chip_smoke.py --cpu-rehearsal    # the same path, tiny, plain versions, CPU

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version, and drives the port's paths at
the paper's ImageNet shape (n = 1,262,102, d = 900, k = 164) on blobs made
from ``--seed``: the local backend (``KernelKMeans(164, kernel="rbf",
method="nystrom", l=500, m=256).fit(X)`` then ``predict``), the stream
backend over a pinned host copy of X in 4,096-row blocks (the same fit
through the fused Lloyd-step kernel, O(block) on the card), the rff member on
both backends, and the embed-once sweep over that store under the int8, f32
and bf16 caches (``KernelKMeans(...).sweep(store, k_grid=[82, 164],
restarts=2)``, every block's Lloyd step over a compressed cache in
``fused_dequant_step``). Phase ``persist`` then saves and loads the local
and rff models, crashes the stream and minibatch fits mid-Lloyd through a
store whose reads fail and resumes them with ``checkpoint_dir=`` bit for
bit, runs the int8 sweep twice over one ``checkpoint_dir`` (the second
from the persisted stage, with no embedding pass), and streams the store
through ``partial_fit``. Phase ``baselines`` runs the paper's Table 2 on the
imagenet-50k stand-in (exact kernel k-means on the full 50,000 x 50,000
Gram, approximate kernel k-means, RFF and SV-RFF k-means, two-stage, the
legacy ``fit_predict`` / ``predict``), each also held on the CPU at 4,000
rows; phase ``obs`` checks every fit's and sweep's ``FitReport`` against
the engine's counts, traces phase stream's fit once more into a Chrome
trace, and joins its report with the H100's roofline. Phase ``serve`` saves
phase main's Nystrom model and phase rff's model and serves them through the
online assignment service (``repro_torch.launch.cluster_serve`` closed loop,
then open loop with a hot swap from one to the other, then both by name in
one ``ModelRegistry``, closed loop and an overload), every served label
replayed exactly against ``core.kkmeans.predict``, one embedding launch and
one ``apnc_assign`` launch a flush. Phase ``examples`` runs the port's five
documented scripts (``examples/torch_*.py``) in this process at their
defaults, each with its launches counted and what it prints gated. It then
serves qwen1.5-0.5b at full width and
depth from a seeded random init (``repro_torch.launch.serve.generate``: a
4 x 4,096-token prefill, every layer's attention in ``flash_attention_bhsd``,
then 32 greedy decode steps over a bf16 KV cache), held against the plain
attention, against a decode of the prompt's last token and against an int8
cache. Phase ``lm_train`` trains it: (a) 20 AdamW steps of qwen1.5-0.5b at
full width and depth on 4 x 2,048 tokens a step (``make_train_step`` over
``batch_iterator``; every attention forward in ``flash_attention_bhsd``
through its ``autograd.Function``, the backward a recompute in ``torch``
ops), with a traced step's split; (b) the Function's gradients against
autograd through the plain attention at two full shapes, timed beside
``scaled_dot_product_attention``'s backward; (c) one full-width step, kernel
route against plain route, every attention projection with a non-zero
gradient; (d) ``TrainLoop`` crashed by its fault hook and resumed from its
checkpoint bit for bit; (e) qwen2-moe-a2.7b at full width, 2 layers:
generate, decode against the full forward, 5 train steps. Phase ``lm_ssm``
serves the SSM and frontend archs at their published widths through
``serve.generate``: (a) rwkv6-3b whole, (b) one jamba-1.5-large-398b group
(bf16, 4 of its 16 experts), (c) musicgen-large whole, (d) llava-next-34b
on 2 layers, each also reduced, card against CPU and decode against the
full forward. Phase ``lm_ssm_train`` trains them at full width: (a)
rwkv6-3b on 16 of its 32 layers and (b) jamba at d_model 8,192 on a
Mamba + dense and a Mamba + MoE layer (2 of 16 experts), a few AdamW steps
each, split into forward, backward and optimizer, the peak beside the
dry-run's placement; (c) one reduced step of each, card against CPU. Phase
``lm_mesh`` runs
qwen1.5-0.5b at full width and depth on device meshes of logical shards of
the card (``distributed.parallel``, placed by ``distributed.sharding``'s
rules): (a) 5 AdamW steps on (1, 2),
(2, 1) and (2, 2) against one device, (b) prefill and greedy decode on
(1, 2), (c) the sequence-sharded decode against a 32,768-position cache on
(2, 1), (d) int8 error-feedback DDP on (8, 1), (e) the GPipe pipeline on a
(4, 1) pipe axis, (f) the (2, 2) state restored onto (1, 2) and (1, 1) bit
for bit. Phase ``lm_mesh_ssm`` puts the Mamba and RWKV6 layers under a
model axis: (g) rwkv6-3b whole on (1, 2) and (2, 2), (h) one jamba group
in bf16 and two of its layers in f32 on (1, 2), served against one device,
(i) a train step of each on 2 layers. Phase ``dryrun`` holds the dry-run's
count of a (1, 2) train step on ``meta`` devices against the same step on
the card (each coordinate's bytes, the GEMM flops), and reads seven
dry-run cells that ran on ``meta`` in low-priority worker processes beside
the LM phases. It holds ``apnc_assign_step`` (labels, Z, g and the block's cost in
one launch) bit for bit against the three fused steps on the Y each one's
un-fused chain makes. It holds ``kmeanspp_seed`` (a restart's k - 1 k-means++
picks in one launch) bit for bit against its plain version on the main
shape's embedded rows, on a 1,024-row pool and on a 16 k-row sample. It times each kernel beside its bound, its plain
version and a PyTorch library call (chain). Every phase prints
one JSON line. The last lines are the kernel table, the card's name and power
limit, and ``{"ok": true, ...}``; any failure exits non-zero before them.
Without a card the script exits non-zero, unless ``--cpu-rehearsal`` is given,
which never prints the ok line. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

if "--cpu-rehearsal" in sys.argv[1:]:
    # One CPU thread for every library on every thread the run starts: the
    # service's dispatcher and swap threads would otherwise each start a
    # team of math-library threads at their first op (0.07 s a kind of op
    # on a shared CPU), enough for a hot swap to land after the last request.
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("MKL_NUM_THREADS", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.configs.paper_datasets import PAPER_DATASETS  # noqa: E402

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data sheet).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12  # dense, on the tensor cores
PEAK_F64_FLOPS = 34e12  # off the tensor cores

# The paper's ImageNet configuration: n, d, k and the blobs' separation from
# the port's configs/paper_datasets.py (the JAX package's table), the rest
# this script's. parity_assign: (n, k, m) of the assign parity cases; parity_blobs: (n, d,
# l, m, k) of the fused-step parity cases on blob data.
# parity_dequant: (n, k, m) of the fused_dequant_step cases; the last m is
# above the kernel's limit and takes the decode route. parity_assign_step:
# the n of the bitwise checks of apnc_assign_step against the fused steps (a
# full block, one row more, several tiles a CTA); assign_wide: (n, k, m) of
# its streamed kernel above apnc_assign.MAX_M.
_IMAGENET = PAPER_DATASETS["imagenet"]
IMAGENET = dict(n=_IMAGENET.n, d=_IMAGENET.d, k=_IMAGENET.k, separation=_IMAGENET.separation,
                l=500, m=256, iters=20,
                block_rows=4096, rff_m=128, sweep_k_grid=(82, 164), sweep_restarts=2,
                parity_assign=((5003, 67, 70), (20_011, 164, 256)),
                parity_assign_step=(4096, 4097, 40_000), assign_wide=(1500, 70, 1000),
                parity_blobs=((4096, 77, 150, 100, 67), (1003, 130, 70, 64, 9)),
                parity_dequant=((4096, 67, 24), (1003, 9, 256), (4096, 164, 256),
                                (1003, 67, 800), (1003, 9, 900)),
                parity_flash=((4, 32, 16, 64), (1, 1000, 8, 128), (2, 257, 3, 40),
                              (1, 4096, 16, 64), (1, 2048, 32, 128), (4, 1024, 32, 64)),
                parity_flash_gqa=((1, 2048, 32, 8, 128), (2, 257, 6, 3, 40),
                                  (2, 1024, 64, 8, 128), (1, 3008, 64, 8, 128),
                                  (2, 1024, 32, 4, 128)),
                lm_arch="qwen1.5-0.5b", lm_reduced=False, lm_batch=4, lm_prompt=4096,
                lm_gen=32,
                # Phase lm_train: (a) qwen1.5-0.5b unreduced, batch x seq, steps; (b)
                # the attention gradients at (B, S, H, Hkv, Dh): qwen1.5-0.5b's
                # training heads, llama3-8b's grouped heads; (c) and (d) at
                # step_layers of its layers, (d) crashed at crash_at and resumed
                # from the checkpoint every resume_every; (e) qwen2-moe-a2.7b
                # at moe_layers layers.
                lm_train=dict(arch="qwen1.5-0.5b", reduced=False, batch=4, seq=2048, steps=20,
                              lr=3e-3, grad_shapes=((4, 2048, 16, 16, 64), (1, 4096, 32, 8, 128)),
                              step_layers=2, resume_steps=20, resume_every=10, crash_at=12,
                              moe_arch="qwen2-moe-a2.7b", moe_layers=2, moe_batch=2, moe_seq=2048,
                              moe_gen=16, moe_steps=5),
                # Phase lm_ssm: each part's arch at its published widths, the
                # depth (layers) and experts cut where given, its prompt of
                # `prompt` model positions (llava: 2,880 patches + 128 tokens)
                # and `gen` greedy decode steps; `check`: the reduced models'
                # card vs CPU and decode vs full gates, batch x prompt, steps.
                lm_ssm=dict(reduced=False,
                            rwkv=dict(arch="rwkv6-3b", batch=4, prompt=1024, gen=16),
                            jamba=dict(arch="jamba-1.5-large-398b", layers=8, experts=4,
                                       dtype="bfloat16", batch=2, prompt=1024, gen=16),
                            musicgen=dict(arch="musicgen-large", batch=4, prompt=1024, gen=16),
                            llava=dict(arch="llava-next-34b", layers=2, batch=1, prompt=3008,
                                       gen=16),
                            check=dict(batch=2, prompt=16, steps=4)),
                # Phase lm_ssm_train: (a) rwkv6-3b at its published widths and
                # `layers` depth (all 32 took 69.3 s for a step inside the whole
                # run on an H100 80GB HBM3 at 700 W, past the 60 s that cuts
                # it to 16), (b) jamba at full width on 2 layers with its
                # experts cut to `experts`; batch x seq tokens, `steps` AdamW
                # steps at `lr`; `peak_gb` and `step_s`: PERF.md's predictions;
                # (c) one step of each reduced arch, card vs CPU, on check's
                # batch x seq. The rates: Adam's first step moves every
                # parameter by about lr, and at rwkv6-3b's init 3e-5 and above
                # raise the next batch's loss (tools/first_step_probe.py;
                # PERF.md §6).
                lm_ssm_train=dict(reduced=False,
                                  rwkv=dict(arch="rwkv6-3b", layers=16, batch=2, seq=1024,
                                            steps=3, lr=3e-6, peak_gb=36, step_s=[25, 30]),
                                  jamba=dict(arch="jamba-1.5-large-398b", layers=2, experts=2,
                                             batch=1, seq=1024, steps=3, lr=1e-4,
                                             peak_gb=[52, 62], step_s=[2, 4]),
                                  check=dict(batch=2, seq=32, lr=1e-3)),
                # Phase lm_mesh, on logical shards of the card: (a) `steps`
                # AdamW steps of lm_train (a)'s model and batches on one device
                # and on each (data, model) mesh; (b) serving on serve_mesh;
                # (c) the sequence-sharded decode against a seq_cache-position
                # bf16 cache on seq_mesh; (d) int8 DDP on ddp_mesh; (e) the
                # pipeline on 4 stages; (f) (a)'s elastic_from state restored
                # onto each elastic_to mesh.
                lm_mesh=dict(arch="qwen1.5-0.5b", reduced=False, batch=4, seq=2048, steps=5,
                             lr=3e-3, meshes=((1, 2), (2, 1), (2, 2)), serve_mesh=(1, 2),
                             serve_batch=4, serve_prompt=4096, serve_gen=32, seq_mesh=(2, 1),
                             seq_cache=32_768, ddp_mesh=(8, 1), ddp_steps=150,
                             elastic_from=(2, 2), elastic_to=((1, 2), (1, 1))),
                # Phase lm_mesh_ssm, on logical shards of the card: (g) rwkv6-3b
                # whole and (h) one jamba group (its lm_ssm cell) served on
                # each of their meshes against one device; (i) one train step
                # of `layers` layers, batch x seq tokens, on each of `meshes`
                # (jamba at `jamba_width`: full-width training is ROADMAP item
                # 21).
                lm_mesh_ssm=dict(reduced=False,
                                 rwkv=dict(arch="rwkv6-3b", batch=4, prompt=1024, gen=16,
                                           meshes=((1, 2), (2, 2))),
                                 jamba=dict(arch="jamba-1.5-large-398b", layers=8, experts=4,
                                            dtype="bfloat16", batch=2, prompt=1024, gen=16,
                                            meshes=((1, 2),)),
                                 jamba_f32=dict(experts=4, batch=2, prompt=1024, gen=16,
                                                meshes=((1, 2),)),
                                 train=dict(layers=2, batch=2, seq=256, lr=3e-3,
                                            meshes=((1, 2), (2, 2)), jamba_width=2048,
                                            jamba_experts=4)),
                # Phase dryrun: lm_mesh (a)'s cell (arch, batch x seq, one train
                # step, f32) counted on a `mesh` of meta devices and run on the
                # same mesh of logical shards of the card; then `cells` of the
                # dry-run on meta, `jobs` at a time.
                dryrun=dict(arch="qwen1.5-0.5b", reduced=False, batch=4, seq=2048, mesh=(1, 2),
                            cells=(("qwen1.5-0.5b", "train_4k", False),
                                   ("qwen1.5-0.5b", "prefill_32k", False),
                                   ("qwen1.5-0.5b", "decode_32k", False),
                                   ("qwen1.5-0.5b", "long_500k", False),
                                   ("qwen1.5-0.5b", "decode_32k", True),
                                   ("jamba-1.5-large-398b", "decode_32k", False),
                                   ("rwkv6-3b", "decode_32k", False)), jobs=4),
                # Phase examples: each examples/torch_*.py and the argv it runs
                # with (its defaults on the card).
                examples=dict(torch_quickstart=(), torch_stream_quickstart=(),
                              torch_covtype_scale=(), torch_activation_clustering=(),
                              torch_train_lm=()),
                # Table 2 on the card: the imagenet-50k stand-in (50,000 rows,
                # the ImageNet d, k and separation, warped), 10,000 more rows
                # of its mixture held out; `small_n` rows for card vs CPU.
                baselines=dict(dataset="imagenet-50k", held_out=10_000, l=500, m=256,
                               rff_m=128, iters=20, small_n=4_000),
                # The online service over phase main's and phase rff's models:
                # requests a run, rows a flush, the micro-batch deadline, (b)'s
                # rate and (c)'s overload as multiples of (a)'s req/s, (c)'s
                # admission bound, the calls timing one flush.
                serve=dict(requests=20_000, micro_batch=256, max_delay_ms=2.0, open_rate=0.5,
                           overload=4.0, max_inflight=256, flush_iters=200))
REHEARSAL = dict(n=4_000, d=32, k=8, separation=3.0, l=64, m=16, iters=20,
                 block_rows=512, rff_m=16, sweep_k_grid=(4, 8), sweep_restarts=2,
                 parity_assign=((503, 7, 19), (2003, 13, 32)),
                 parity_assign_step=(64, 65, 300), assign_wide=(70, 5, 40),
                 parity_blobs=((515, 13, 40, 24, 7), (203, 9, 24, 12, 5)),
                 parity_dequant=((515, 7, 24), (203, 5, 40)),
                 parity_flash=((2, 32, 2, 16), (1, 77, 2, 40)),
                 parity_flash_gqa=((1, 77, 4, 2, 16), (2, 16, 4, 1, 16)),
                 lm_arch="qwen1.5-0.5b", lm_reduced=True, lm_batch=4, lm_prompt=64, lm_gen=8,
                 lm_train=dict(arch="qwen1.5-0.5b", reduced=True, batch=2, seq=64, steps=20,
                               lr=3e-3, grad_shapes=((2, 64, 4, 4, 16), (1, 96, 4, 2, 32)),
                               step_layers=2, resume_steps=20, resume_every=10, crash_at=12,
                               moe_arch="qwen2-moe-a2.7b", moe_layers=2, moe_batch=2, moe_seq=64,
                               moe_gen=4, moe_steps=5),
                 lm_ssm=dict(reduced=True,
                             rwkv=dict(arch="rwkv6-3b", batch=2, prompt=16, gen=4),
                             jamba=dict(arch="jamba-1.5-large-398b", layers=8, experts=4,
                                        dtype="bfloat16", batch=2, prompt=16, gen=4),
                             musicgen=dict(arch="musicgen-large", batch=2, prompt=16, gen=4),
                             llava=dict(arch="llava-next-34b", layers=2, batch=1, prompt=16,
                                        gen=4),
                             check=dict(batch=2, prompt=16, steps=4)),
                 lm_ssm_train=dict(reduced=True,
                                   rwkv=dict(arch="rwkv6-3b", layers=2, batch=4, seq=32,
                                             steps=3, lr=1e-2, peak_gb=None, step_s=None),
                                   jamba=dict(arch="jamba-1.5-large-398b", layers=2,
                                              experts=2, batch=4, seq=32, steps=3, lr=1e-2,
                                              peak_gb=None, step_s=None),
                                   check=dict(batch=2, seq=32, lr=1e-3)),
                 lm_mesh=dict(arch="qwen1.5-0.5b", reduced=True, batch=4, seq=64, steps=3,
                              lr=3e-3, meshes=((1, 2), (2, 1), (2, 2)), serve_mesh=(1, 2),
                              serve_batch=4, serve_prompt=32, serve_gen=4, seq_mesh=(2, 1),
                              seq_cache=64, ddp_mesh=(8, 1), ddp_steps=150,
                              elastic_from=(2, 2), elastic_to=((1, 2), (1, 1))),
                 lm_mesh_ssm=dict(reduced=True,
                                  rwkv=dict(arch="rwkv6-3b", batch=2, prompt=16, gen=4,
                                            meshes=((1, 2), (2, 2)), padded_heads=6),
                                  jamba=dict(arch="jamba-1.5-large-398b", layers=8, experts=4,
                                             dtype="bfloat16", batch=2, prompt=16, gen=4,
                                             meshes=((1, 2),)),
                                  jamba_f32=dict(experts=4, batch=2, prompt=16, gen=4,
                                                 meshes=((1, 2),)),
                                  train=dict(layers=2, batch=2, seq=16, lr=3e-3,
                                             meshes=((1, 2), (2, 2)), jamba_width=64,
                                             jamba_experts=4, padded_heads=6)),
                 dryrun=dict(arch="qwen1.5-0.5b", reduced=True, batch=4, seq=64, mesh=(1, 2),
                             cells=(), jobs=1),
                 # the CI sizes of tests/test_torch_examples.py
                 examples=dict(torch_quickstart=(), torch_stream_quickstart=(),
                               torch_covtype_scale=("--smoke",),
                               torch_activation_clustering=("--smoke",),
                               torch_train_lm=("--steps", "8", "--d-model", "64", "--layers",
                                               "2", "--batch", "2", "--seq", "32")),
                 baselines=dict(dataset=None, n=1_500, held_out=300, l=64, m=16, rff_m=16,
                                iters=20, small_n=400),
                 serve=dict(requests=2_000, micro_batch=64, max_delay_ms=2.0, open_rate=0.5,
                            overload=4.0, max_inflight=64, flush_iters=20))
#: Sliding windows of the attention parity cases (4,096: mixtral's).
FLASH_WINDOWS = (0, 50, 4096)
#: The reference's tolerances for flash attention (tests/test_kernels_pallas.py).
FLASH_TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (5e-2, 5e-2)}
#: The redesigned kernels' times in their first CUDA design (ms a pass or a
#: launch, as the timing phase takes them; the range of PERF.md's chip runs
#: on an H100 80GB HBM3 at 700 W), printed beside this run's.
PREVIOUS_MS = {
    "fused_apnc_step": dict(previous_ms=[242.39, 244.3], previous_from="first CUDA design"),
    "rff_embed_block": dict(previous_ms=[38.33, 39.0], previous_from="first CUDA design"),
    "apnc_embed": dict(previous_ms=[71.09, 71.61], previous_from="first CUDA design"),
    "flash_attention_bhsd": dict(previous_ms=[4.98, 5.0], previous_from="first CUDA design"),
    "fused_dequant_step": dict(previous_ms=[27.14, 45.16], previous_from="first CUDA design"),
    "fused_rff_step": dict(previous_ms=[77.41, 78.2], previous_from="first CUDA design"),
    "apnc_assign": dict(previous_ms=[7.82, 7.87],
                        previous_from="first CUDA design, without the cost")}
#: Device-memory rise allowed over a stream fit (the data is 4.54 GB).
STREAM_RISE_LIMIT = 512 << 20


#: perf_counter() when main() started: each phase line carries its end as
#: ``at_s`` seconds after it.
START = [time.perf_counter()]


def emit(obj) -> None:
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - START[0])
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_blobs(n, d, k, separation, seed, device, anisotropy=0.5, chunk=1 << 16):
    """Gaussian blobs made on ``device`` from a torch.Generator; labels int64."""
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((k, d), generator=g, device=device) * separation
    scales = 1.0 + anisotropy * torch.rand((k, d), generator=g, device=device)
    labels = torch.randint(0, k, (n,), generator=g, device=device)
    X = torch.empty((n, d), device=device)
    for lo in range(0, n, chunk):
        lab = labels[lo:lo + chunk]
        X[lo:lo + chunk] = centers[lab] + torch.randn(
            (lab.shape[0], d), generator=g, device=device) * scales[lab]
    return X, labels


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_close(what, got, want, rtol, atol) -> float:
    """max |got - want|, raising unless |got - want| <= atol + rtol * |want|."""
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    if bad or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: {bad} elements beyond rtol={rtol} atol={atol}, "
                             f"max |d| = {float(err.max())}")
    return float(err.max())


# ----------------------------------------------------------------- phases


# Template arguments of the port's kernels, as the Itanium ABI mangles them.
_TEMPLATE_ARGS = {"ILb0E": "<false>", "ILb1E": "<true>", "IfE": "<float>",
                  "I13__nv_bfloat16E": "<bf16>", "IaLb0EE": "<int8, false>",
                  "IaLb1EE": "<int8, true>", "ItLb0EE": "<bf16, false>",
                  "ItLb1EE": "<bf16, true>", "IaE": "<int8>", "ItE": "<bf16>",
                  **{f"ILb{a}ELb{b}EE": f"<{bool(a)}, {bool(b)}>".lower()
                     for a in (0, 1) for b in (0, 1)},
                  **{f"I{c}Li{dp}ELb{v}EE": f"<{t}, {dp}, {'16-byte' if v else '4-byte'} copies>"
                     for c, t in (("f", "float"), ("t", "bf16")) for dp in (64, 128, 256)
                     for v in (0, 1)},
                  **{f"IN6apncml8GeometryI{geo}EE{x}Lb{v}EE":
                     f"<{name}, {t}, {'16-byte' if v else '4-byte'} copies>"
                     for geo, name in (("Li32ELi4ELi8ELi64ELi4E", "Short"),
                                       ("Li64ELi8ELi8ELi32ELi8E", "Tall"))
                     for x, t in (("f", "float"), ("13__nv_bfloat16", "bf16")) for v in (0, 1)}}


def entry_name(mangled: str) -> str:
    """The unqualified name of a mangled kernel entry: the last
    <length><identifier> of its (nested) name, with its template argument."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        size = int(mangled[i:j])
        name, i = mangled[j:j + size], j + size
    for code, text in sorted(_TEMPLATE_ARGS.items(), key=lambda kv: -len(kv[0])):
        if mangled.startswith(code, i):
            return name + text
    return name


def phase_build() -> dict:
    from repro_torch.kernels import apnc_assign, apnc_embed, build, flash_attention, lloyd_step

    t0 = time.perf_counter()
    build.build_all()
    entries = []
    for name in build.SOURCES:
        fn = None
        for line in build.ptxas_report(name).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = dict(source=name, kernel=entry_name(m.group(1)))
                entries.append(fn)
            elif fn is not None:
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads"),
                                 ("static_smem", r"(\d+) bytes smem")):
                    m2 = re.search(pat, line)
                    if m2:
                        fn[key] = int(m2.group(1))
    spills = [e for e in entries if e.get("spill_stores") or e.get("spill_loads")]
    cfg = IMAGENET
    return dict(phase="build", seconds=time.perf_counter() - t0,
                nvcc_seconds=dict(build.BUILD_SECONDS), ptxas=entries,
                spilling_kernels=len(spills),
                dynamic_smem_bytes_main_shape=dict(
                    apnc_embed=apnc_embed.smem_bytes(cfg["n"], cfg["m"]),
                    apnc_assign=apnc_assign.smem_bytes(cfg["m"], cfg["k"]),
                    fused_apnc_step=lloyd_step.smem_bytes("apnc", cfg["m"]),
                    fused_rff_step=lloyd_step.smem_bytes("rff", 2 * cfg["rff_m"]),
                    fused_dequant_step=lloyd_step.smem_bytes("dequant", cfg["m"]),
                    flash_attention_bhsd=flash_attention.smem_bytes(64)),
                apnc_embed_tile_rows=dict(whole_x=apnc_embed.tile_rows(cfg["n"], cfg["m"]),
                                          block=apnc_embed.tile_rows(cfg["block_rows"], cfg["m"])),
                apnc_embed_smem_bytes_block=apnc_embed.smem_bytes(cfg["block_rows"], cfg["m"]),
                flash_attention_smem_bytes_by_head_dim={
                    dh: dict(f32=flash_attention.smem_bytes(dh),
                             bf16=flash_attention.smem_bytes(dh, torch.bfloat16))
                    for dh in (40, 64, 128, 256)},
                dequant_max_m=lloyd_step.DEQUANT_MAX_M,
                dynamic_smem_bytes_dequant_max_m=lloyd_step.smem_bytes(
                    "dequant", lloyd_step.DEQUANT_MAX_M),
                apnc_assign=assign_build(entries, cfg))


def assign_build(entries, cfg) -> dict:
    """The assign kernels' ptxas lines (registers, spills) and, for the tiled
    kernel at the main path's m and the streamed one at assign_wide's m, the
    dynamic shared memory a CTA and the CTAs an SM holds at once."""
    from repro_torch.kernels import apnc_assign

    k = cfg["k"]
    return dict(max_m=apnc_assign.MAX_M,
                ptxas=[e for e in entries if e["source"] == "apnc_assign"],
                **{name: dict(m=m, dynamic_smem_bytes=apnc_assign.smem_bytes(m, k),
                              ctas_per_sm=apnc_assign.ctas_per_sm(m, k))
                   for name, m in (("tiled", cfg["m"]), ("wide", cfg["assign_wide"][2]))})


def blob_block(n, d, k, seed, device):
    """Separated blobs at unit scale and their classes: with the embedded
    class means as centroids every row's nearest centroid wins by a wide
    margin, so a kernel and its plain version must agree on every label."""
    g = torch.Generator().manual_seed(seed)
    centers = torch.randn((k, d), generator=g) * 4.0
    lab = torch.randint(0, k, (n,), generator=g)
    X = (centers[lab] + torch.randn((n, d), generator=g)) * d ** -0.5
    return X.to(device), lab.to(device)


def class_means(Y, lab, k):
    lab = lab.long()
    C = torch.zeros((k, Y.shape[1]), device=Y.device).index_add_(0, lab, Y)
    return (C / torch.bincount(lab, minlength=k).clamp(min=1).float()[:, None]).contiguous()


def check_step(what, run, plain, cost_rtol=1e-5) -> dict:
    """A fused Lloyd step against its plain version: labels and g equal, Z
    within rtol 1e-4 and atol 1e-4 * max|Z|, cost within ``cost_rtol`` (1e-5;
    1e-4 for the dequant step), and two runs bitwise equal."""
    (Z, g, lab, cost), again = run(), run()
    Zr, gr, lr, cr = plain()
    if not (torch.equal(lab, lr) and torch.equal(g, gr)):
        raise AssertionError(f"{what}: labels or g differ ({int((lab != lr).sum())} labels)")
    if not all(torch.equal(a, b) for a, b in zip((Z, g, lab, cost), again)):
        raise AssertionError(f"{what}: two runs differ")
    z_err = check_close(f"{what} Z", Z, Zr, 1e-4, 1e-4 * float(Zr.abs().max()))
    cost_err = check_close(f"{what} cost", cost, cr, cost_rtol, 0.0)
    return dict(labels_equal=True, g_equal=True, deterministic=True, z_max_abs_err=z_err,
                z_abs_max=float(Zr.abs().max()), cost_abs_err=cost_err,
                cost_rel_err=cost_err / abs(float(cr)))


def rff_tolerance(X, W, scale) -> float:
    """The projection X W is a sum of d products taken in another order than
    the plain GEMM's: its error is a few ulp of sum |x_i w_i|, and cos / sin
    pass it on with slope <= 1, times the scale."""
    return 8 * 2.0 ** -24 * X.shape[1] * float((X.abs() @ W.abs()).max()) * scale


def parity_fused(X, truth, device, cfg) -> dict:
    """The three fused / RFF kernels against their plain versions: blob
    blocks over every kernel function, both APNC members and ragged shapes,
    then a 4,096-row block and the ragged last block of the main data at the
    main path's shapes, with the class means of its truth as centroids."""
    from repro_torch.core.kernels_fn import Kernel, self_tuned_rbf
    from repro_torch.embed.apnc import fit_nystrom, fit_sd
    from repro_torch.kernels import lloyd_step, ref, rff_embed

    out = dict(fused_apnc=[], rff_embed=[], fused_rff=[])
    kernels = (Kernel("rbf", gamma=0.05), Kernel("poly", degree=3, coef0=1.0),
               Kernel("tanh", scale=0.01, coef0=0.1), Kernel("linear"))
    for n, d, l, m, k in cfg["parity_blobs"]:
        Xb, lab = blob_block(n, d, k, 11, device)
        for kern in kernels:
            for fit in (fit_nystrom, fit_sd):
                p = fit(4, Xb, kern, l=l, m=m)
                L, R = p.landmarks[0].contiguous(), p.R[0].contiguous()
                C = class_means(ref.apnc_embed_ref(Xb, p.landmarks, p.R, kern), lab, k)
                res = check_step(
                    f"fused_apnc_step {kern.name} {p.discrepancy} n={n}",
                    lambda: lloyd_step.fused_apnc_step(Xb, L, R, C, kern, p.discrepancy),
                    lambda: ref.fused_apnc_step_ref(Xb, L, R, C, kern, p.discrepancy))
                out["fused_apnc"].append(dict(kernel=kern.name, disc=p.discrepancy, n=n, d=d,
                                              l=l, m=m, k=k, **res))
    # The main path's shapes: a full block and the ragged last block.
    bn, k = cfg["block_rows"], cfg["k"]
    rows = torch.cat([X[:bn], X[-(X.shape[0] % bn or bn):]])
    truth_rows = torch.as_tensor(np.concatenate([truth[:bn], truth[-(X.shape[0] % bn or bn):]]),
                                 device=device)
    kern = self_tuned_rbf(rows[:bn])
    p = fit_nystrom(2, rows[:bn], kern, l=cfg["l"], m=cfg["m"])
    L, R = p.landmarks[0].contiguous(), p.R[0].contiguous()
    C = class_means(ref.apnc_embed_ref(rows, p.landmarks, p.R, kern), truth_rows, k)
    for what, blk in (("block", rows[:bn]), ("last block", rows[bn:])):
        res = check_step(f"fused_apnc_step main shape, {what}",
                         lambda: lloyd_step.fused_apnc_step(blk, L, R, C, kern, "l2"),
                         lambda: ref.fused_apnc_step_ref(blk, L, R, C, kern, "l2"))
        out["fused_apnc"].append(dict(kernel="rbf", disc="l2", n=blk.shape[0], d=blk.shape[1],
                                      l=cfg["l"], m=cfg["m"], k=k, main_shape=True, **res))

    # RFF: W ~ N(0, 2 gamma) with the self-tuned gamma, as the member draws it.
    n, d, _, m, k = cfg["parity_blobs"][1]
    cases = [(blob_block(n, d, k, 12, device), m + 1, 0.125),
             ((rows, truth_rows), cfg["rff_m"], kern.gamma)]
    for (Xb, lab), mh, gamma in cases:
        g = torch.Generator().manual_seed(13)
        W = (torch.randn((Xb.shape[1], mh), generator=g) * (2.0 * gamma) ** 0.5).to(device)
        scale = mh ** -0.5
        Y, Yr = rff_embed.rff_embed_block(Xb, W, scale), ref.rff_embed_ref(Xb, W, scale)
        tol = rff_tolerance(Xb, W, scale)
        err = check_close(f"rff_embed n={Xb.shape[0]}", Y, Yr, 0.0, tol)
        out["rff_embed"].append(dict(n=Xb.shape[0], d=Xb.shape[1], m_half=mh, max_abs_err=err,
                                     atol=tol))
        C = class_means(Yr, lab, int(lab.max()) + 1)
        blocks = (("block", Xb[:bn]), ("last block", Xb[bn:])) if Xb is rows else (("", Xb),)
        for what, blk in blocks:
            res = check_step(f"fused_rff_step n={blk.shape[0]} {what}",
                             lambda: lloyd_step.fused_rff_step(blk, W, C, scale, "l2"),
                             lambda: ref.fused_rff_step_ref(blk, W, C, scale, "l2"))
            out["fused_rff"].append(dict(n=blk.shape[0], d=blk.shape[1], m_half=mh,
                                         k=C.shape[0], **res))
    return out


def encoded_blob(n, m, k, codec, seed, device):
    """A blob block staged under ``codec`` by the port's host encoder: its
    wire form on ``device`` and the class means of the decoded rows."""
    from repro_torch.kernels import ref
    from repro_torch.stream.blockstore import EncodedBlock, get_codec

    Y, lab = blob_block(n, m, k, seed, "cpu")
    enc = to_device(EncodedBlock(*get_codec(codec).encode(Y.numpy())), device)
    return enc, class_means(ref.dequant_ref(*enc), lab.to(device), k)


def to_device(enc, device):
    """A host EncodedBlock (numpy payload and scale) as tensors on ``device``."""
    from repro_torch.stream.blockstore import EncodedBlock
    from repro_torch.stream.engine import host_tensor

    return EncodedBlock(host_tensor(enc.payload).to(device),
                        host_tensor(np.asarray(enc.scale, np.float32)).to(device))


def parity_dequant(device, cfg) -> list:
    """fused_dequant_step against its plain version on blob data: int8 and
    bf16, l2 and l1, ragged n, k = 67 and 9, m from 24 to the kernel's limit,
    and one m above it through the plan's decode route (the decode kernel,
    then apnc_assign). Gated as check_step, with the cost within rtol 1e-4."""
    from repro_torch.kernels import lloyd_step, ops, ref

    out = []
    for n, k, m in cfg["parity_dequant"]:
        for codec in ("int8", "bf16"):
            for disc in ("l2", "l1"):
                enc, C = encoded_blob(n, m, k, codec, 21, device)
                route = "fused" if m <= lloyd_step.DEQUANT_MAX_M else "decode"
                res = check_step(
                    f"fused_dequant_step {codec} {disc} n={n} k={k} m={m} ({route})",
                    lambda: ops.dequant_step(enc, C, disc),
                    lambda: ref.fused_dequant_step_ref(enc.payload, enc.scale, C, disc),
                    cost_rtol=1e-4)
                decode_equal = bool(torch.equal(lloyd_step.dequant_decode(*enc),
                                                ref.dequant_ref(*enc)))
                if not decode_equal:
                    raise AssertionError(f"dequant_decode {codec} m={m} differs from plain")
                out.append(dict(codec=codec, disc=disc, n=n, k=k, m=m, route=route,
                                decode_equal=decode_equal, **res))
    return out


def same_bits(what, got, want) -> None:
    """Raise unless the two (Z, g, labels, cost) tuples are bitwise equal."""
    names = ("Z", "g", "labels", "cost")
    differ = [nm for nm, a, b in zip(names, got, want) if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"{what}: {', '.join(differ)} differ")


def parity_assign_step(X, device, cfg) -> dict:
    """apnc_assign_step against the three fused steps, each on the Y its
    un-fused chain makes (X -> apnc_embed_block, X -> rff_embed_block,
    payload -> dequant_decode, int8 and bf16), at every n of
    cfg["parity_assign_step"], l2 and l1: all four outputs bitwise equal
    (the same epilogue, tiles and reduction), and two launches bitwise
    equal. Centroids are other rows' embeddings, so many rows sit near
    several of them. Then apnc_assign_step against its plain version on blob
    rows (check_step, cost within rtol 1e-4) at the same n and, above
    apnc_assign.MAX_M, its streamed kernel."""
    from repro_torch.core.kernels_fn import self_tuned_rbf
    from repro_torch.embed.apnc import fit_nystrom
    from repro_torch.kernels import apnc_assign, apnc_embed, lloyd_step, ref, rff_embed
    from repro_torch.stream.blockstore import EncodedBlock, get_codec

    k, ns = cfg["k"], cfg["parity_assign_step"]
    n_max = max(ns)
    rows, others = X[:n_max], X[n_max:n_max + k]
    kern = self_tuned_rbf(rows[:4096])
    p = fit_nystrom(5, rows[:4096], kern, l=cfg["l"], m=cfg["m"])
    L, R = p.landmarks[0].contiguous(), p.R[0].contiguous()
    mh = cfg["rff_m"]
    W = (torch.randn((X.shape[1], mh), generator=torch.Generator().manual_seed(31))
         * (2.0 * kern.gamma) ** 0.5).to(device)
    scale = mh ** -0.5
    C_apnc = apnc_embed.apnc_embed_block(others, L, R, kern)
    C_rff = rff_embed.rff_embed_block(others, W, scale)
    step = apnc_assign.apnc_assign_step
    out = dict(bitwise=[], plain=[])
    for n in ns:
        Xn = rows[:n]
        Y = apnc_embed.apnc_embed_block(Xn, L, R, kern)
        Y_rff = rff_embed.rff_embed_block(Xn, W, scale)
        encs = {}
        for codec in ("int8", "bf16"):
            enc = to_device(EncodedBlock(*get_codec(codec).encode(Y.cpu().numpy())), device)
            encs[codec] = (enc, ref.dequant_ref(*to_device(EncodedBlock(
                *get_codec(codec).encode(C_apnc.cpu().numpy())), device)).contiguous())
        for disc in ("l2", "l1"):
            got = step(Y, C_apnc, disc)
            same_bits(f"apnc_assign_step run to run n={n} {disc}", step(Y, C_apnc, disc), got)
            same_bits(f"apnc_assign_step vs fused_apnc_step n={n} {disc}", got,
                      lloyd_step.fused_apnc_step(Xn, L, R, C_apnc, kern, disc))
            same_bits(f"apnc_assign_step vs fused_rff_step n={n} {disc}",
                      step(Y_rff, C_rff, disc),
                      lloyd_step.fused_rff_step(Xn, W, C_rff, scale, disc))
            for codec, (enc, Cq) in encs.items():
                same_bits(f"apnc_assign_step vs fused_dequant_step {codec} n={n} {disc}",
                          step(lloyd_step.dequant_decode(*enc), Cq, disc),
                          lloyd_step.fused_dequant_step(enc.payload, enc.scale, Cq, disc))
            out["bitwise"].append(dict(n=n, disc=disc, m=cfg["m"], k=k,
                                       against=["fused_apnc_step", "fused_rff_step",
                                                "fused_dequant_step int8",
                                                "fused_dequant_step bf16"],
                                       outputs_bitwise_equal=True, run_to_run_equal=True))
    wn, wk, wm = cfg["assign_wide"]
    for n, kk, m in [*((n, k, cfg["m"]) for n in ns), (wn, wk, wm)]:
        Yb, lab = blob_block(n, m, kk, 33, device)
        C = class_means(Yb, lab, kk)
        for disc in ("l2", "l1"):
            res = check_step(f"apnc_assign_step vs plain {disc} n={n} k={kk} m={m}",
                             lambda: step(Yb, C, disc),
                             lambda: ref.apnc_assign_step_ref(Yb, C, disc), cost_rtol=1e-4)
            out["plain"].append(dict(n=n, k=kk, m=m, disc=disc,
                                     kernel="wide" if m > apnc_assign.MAX_M else "tiled", **res))
    return out


def phase_parity(X, truth, device, cfg) -> dict:
    """Each kernel against its plain version on the same inputs."""
    from repro_torch.core.kernels_fn import Kernel, self_tuned_rbf
    from repro_torch.embed.apnc import fit_nystrom
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = dict(phase="parity", embed=[], assign=[])
    g = torch.Generator().manual_seed(17)
    Xr = torch.randn((1003, 77), generator=g).to(device)
    for kern in (Kernel("rbf", gamma=0.05), Kernel("poly", degree=3, coef0=1.0),
                 Kernel("tanh", scale=0.01, coef0=0.1), Kernel("linear")):
        for q, m in ((1, 33), (2, 21)):
            params = fit_nystrom(1, Xr, kern, l=100, m=m, q=q)
            got, want = ops.apnc_embed(Xr, params), ref.apnc_embed_ref(
                Xr, params.landmarks, params.R, kern)
            tol = 2e-3 if kern.name == "poly" else 2e-5  # poly amplifies roundoff
            err = check_close(f"embed {kern.name} q={q}", got, want, tol,
                              tol * float(want.abs().max()))
            out["embed"].append(dict(kernel=kern.name, q=q, n=1003, d=77, l=100, m=m * q,
                                     max_abs_err=err, rtol=tol))
    # The main path's shape on a row slice: rbf, l = 500, m = 256, d = 900.
    rows = X[: min(65_536, X.shape[0])]
    kern = self_tuned_rbf(rows[:4096])
    params = fit_nystrom(2, rows[:4096], kern, l=cfg["l"], m=cfg["m"])
    got, want = ops.apnc_embed(rows, params), ref.apnc_embed_ref(
        rows, params.landmarks, params.R, kern)
    err = check_close("embed main shape", got, want, 2e-5, 2e-5 * float(want.abs().max()))
    out["embed"].append(dict(kernel="rbf", q=1, n=rows.shape[0], d=rows.shape[1],
                             l=cfg["l"], m=cfg["m"], max_abs_err=err, rtol=2e-5))
    out["embed_rows_bitwise"] = embed_rows_bitwise(rows, params, cfg)
    out["kmeanspp_seed"] = parity_kmeanspp(got, cfg["k"], device)
    out["plain_route"] = plain_route(Xr, device)
    for n, k, m in cfg["parity_assign"]:
        Y = torch.randn((n, m), generator=g).to(device)
        C = (torch.randn((k, m), generator=g) * 2).to(device)
        for disc in ("l2", "l1"):
            Z, gg, lab = ops.apnc_assign(Y, C, disc)
            Z2, g2, lab2 = ops.apnc_assign(Y, C, disc)
            Zr, gr, lr = ref.apnc_assign_ref(Y, C, disc)
            if not (torch.equal(lab, lr) and torch.equal(gg, gr)):
                raise AssertionError(f"assign {disc} n={n} k={k}: labels or g differ "
                                     f"({int((lab != lr).sum())} labels)")
            if not (torch.equal(Z, Z2) and torch.equal(gg, g2) and torch.equal(lab, lab2)):
                raise AssertionError(f"assign {disc} n={n} k={k}: two runs differ")
            err = check_close(f"assign Z {disc}", Z, Zr, 1e-4, 1e-4)
            out["assign"].append(dict(disc=disc, n=n, k=k, m=m, labels_equal=True,
                                      g_equal=True, deterministic=True, z_max_abs_err=err))
    out.update(parity_fused(X, truth, device, cfg))
    out["assign_step"] = parity_assign_step(X, device, cfg)
    out["fused_dequant"] = parity_dequant(device, cfg)
    out["flash_attention"] = parity_flash(device, cfg)
    out["flash_attention_gqa"] = parity_flash_gqa(device, cfg)
    sync(device)
    return out


def parity_kmeanspp(Y, k, device) -> list:
    """``kmeanspp_seed`` against its plain version on the same card from the
    same exponentials, on pools of embedded main-shape rows: the estimator's
    1,024-row pool and a distributed fit's 16 k-row sample (a cluster of 16
    CTAs on a card). Gated: picks and centroids bit for bit, for l2 and l1."""
    from repro_torch.kernels import kmeanspp, ref

    out = []
    g = torch.Generator().manual_seed(23)
    for n in (1024, 16 * k):
        pool = Y[:n].contiguous()
        n, m = pool.shape
        E = torch.empty((k - 1, n), dtype=torch.float64).exponential_(
            1, generator=g).to(device)
        cluster = kmeanspp.cluster_size(n, m) if device.type == "cuda" else None
        for disc in ("l2", "l1"):
            picks, C, bad = kmeanspp.kmeanspp_seed(pool, E, 3, disc)
            want_picks, want_C, want_bad = ref.kmeanspp_seed_ref(pool, (E,), 3, k, disc)
            if not (torch.equal(picks, want_picks) and torch.equal(C, want_C)):
                raise AssertionError(f"kmeanspp_seed {disc} {n} x {m} k={k}: "
                                     f"{int((picks != want_picks).sum())} picks differ")
            if bool(bad) or bool(want_bad):
                raise AssertionError(f"kmeanspp_seed {disc} {n} x {m}: a sum of weights was 0")
            out.append(dict(disc=disc, n=n, m=m, k=k, cluster=cluster, picks_equal=True,
                            centroids_bitwise=True))
    if device.type == "cuda" and [r["cluster"] for r in out[::2]] != [8, 16]:
        raise AssertionError(f"kmeanspp_seed clusters {out}: want 8 CTAs, then 16")
    return out


def embed_rows_bitwise(rows, params, cfg) -> dict:
    """apnc_embed_block's rows do not depend on the launch: the rows of one
    launch over ``rows`` (a many-wave launch takes the 64-row geometry) equal
    those of launches over block-row slices of it (32-row geometry), bit for
    bit, since every geometry runs the same fmaf chains."""
    from repro_torch.kernels import apnc_embed

    L, R, kern = params.landmarks[0].contiguous(), params.R[0].contiguous(), params.kernel
    whole = apnc_embed.apnc_embed_block(rows, L, R, kern)
    bn = cfg["block_rows"]
    for lo, hi in ((0, bn), (rows.shape[0] - bn - 7, rows.shape[0]), (3, 70)):
        part = apnc_embed.apnc_embed_block(rows[lo:hi].contiguous(), L, R, kern)
        if not torch.equal(part, whole[lo:hi]):
            raise AssertionError(f"embed rows {lo}:{hi} differ from the whole launch's")
    return dict(n=rows.shape[0], slices=3, bitwise_equal=True,
                tile_rows=dict(whole=apnc_embed.tile_rows(rows.shape[0], R.shape[0])
                               if rows.is_cuda else None,
                               slice=apnc_embed.tile_rows(bn, R.shape[0])
                               if rows.is_cuda else None))


def plain_route(X, device) -> dict:
    """ComputePolicy(kernels=False, precision="bf16") on the device: the
    plain version in bf16, no kernel launch, the CPU's bf16 result."""
    from repro_torch import embed
    from repro_torch.core.kernels_fn import Kernel
    from repro_torch.embed.apnc import fit_nystrom
    from repro_torch.kernels import apnc_assign, apnc_embed, lloyd_step, ops
    from repro_torch.policy import ComputePolicy

    params = fit_nystrom(3, X, Kernel("rbf", gamma=0.05), l=100, m=33)
    pol = ComputePolicy(kernels=False, precision="bf16")
    before = (apnc_embed.launches, apnc_assign.launches, dict(lloyd_step.launches))
    got = embed.transform(params, X, pol)
    ops.lloyd_step_plan(params, policy=pol).step(X, got[:5].clone())
    sync(device)
    if (apnc_embed.launches, apnc_assign.launches, dict(lloyd_step.launches)) != before:
        raise AssertionError("kernels=False launched a kernel")
    want = embed.transform(params.to("cpu"), X.cpu(), pol)
    f32 = embed.transform(params.to("cpu"), X.cpu())
    err = check_close("plain bf16 route on the device vs the CPU", got.cpu(), want, 1e-2,
                      1e-2 * float(want.abs().max()))
    if torch.equal(want, f32):
        raise AssertionError("the bf16 route computed in f32")
    return dict(n=X.shape[0], launches=0, max_abs_err_vs_cpu_bf16=err,
                max_abs_bf16_vs_f32=float((want - f32).abs().max()))


def check_flash(what, q, k, v, window) -> float:
    """flash_attention_bhsd against flash_attention_ref on the same inputs:
    within the reference's tolerance for the dtype, two runs bitwise equal.
    Returns max |kernel - plain|."""
    from repro_torch.kernels import flash_attention, ref

    got = flash_attention.flash_attention_bhsd(q, k, v, window=window)
    again = flash_attention.flash_attention_bhsd(q, k, v, window=window)
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two runs differ")
    want = ref.flash_attention_ref(q, k, v, window)
    rtol, atol = FLASH_TOL[q.dtype]
    return check_close(what, got.float(), want.float(), rtol, atol)


def mesh_flash_shapes(cfg) -> list:
    """(B, S, H, Dh) of each model shard's flash_attention_bhsd calls in
    phase lm_mesh: (a)'s training batch on each mesh and (b)'s prefill, the
    batch split over the data shards (replicated when smaller) and the
    heads over the model shards."""
    from repro_torch.configs import get_arch, reduced

    c = cfg["lm_mesh"]
    arch = reduced(get_arch(c["arch"])) if c["reduced"] else get_arch(c["arch"])
    H, Dh = arch.phys_heads, arch.resolved_head_dim
    cases = [(c["batch"], c["seq"], mesh) for mesh in c["meshes"]]
    cases.append((c["serve_batch"], c["serve_prompt"], c["serve_mesh"]))
    out = []
    for B, S, (D, M) in cases:
        shape = (B if B < D else B // D, S, H // M, Dh)
        if shape not in out:
            out.append(shape)
    return out


def parity_flash(device, cfg) -> list:
    """flash_attention_bhsd against its plain version: (B, S, H, Dh) from the
    launcher's default prompt to 4,096 tokens, ragged S, Dh 40 to 128,
    musicgen-large's prefill in phase lm_ssm, each model shard's calls in
    phase lm_mesh (``mesh_flash_shapes``), every window of FLASH_WINDOWS,
    f32 and bf16."""
    out = []
    g = torch.Generator().manual_seed(23)
    mesh = [s for s in mesh_flash_shapes(cfg) if s not in cfg["parity_flash"]]
    for shape in list(cfg["parity_flash"]) + mesh:
        q32, k32, v32 = (torch.randn(shape, generator=g).to(device) for _ in range(3))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            for window in FLASH_WINDOWS:
                err = check_flash(f"flash_attention {shape} w={window} {dtype}", q, k, v, window)
                out.append(dict(shape=list(shape), window=window, dtype=str(dtype)[6:],
                                max_abs_err=err, rtol=FLASH_TOL[dtype][0],
                                atol=FLASH_TOL[dtype][1], deterministic=True,
                                lm_mesh_shard=shape in mesh))
    return out


def parity_flash_gqa(device, cfg) -> list:
    """flash_attention_bhsd with grouped KV heads (k, v with Hkv < H heads,
    read by head index in the kernel) against its plain version, at
    llama3-8b's heads and phase lm_ssm's jamba and llava prefills (8:1
    groups; llava's 3,008 positions, 2,880 patches and 128 tokens) and a
    model shard's half of jamba's heads in phase lm_mesh_ssm (h)."""
    out = []
    g = torch.Generator().manual_seed(29)
    for B, S, H, Hkv, Dh in cfg["parity_flash_gqa"]:
        q32 = torch.randn((B, S, H, Dh), generator=g).to(device)
        k32, v32 = (torch.randn((B, S, Hkv, Dh), generator=g).to(device) for _ in range(2))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            for window in FLASH_WINDOWS:
                err = check_flash(f"flash_attention gqa {(B, S, H, Hkv, Dh)} w={window} {dtype}",
                                  q, k, v, window)
                out.append(dict(shape=[B, S, H, Hkv, Dh], window=window, dtype=str(dtype)[6:],
                                max_abs_err=err, rtol=FLASH_TOL[dtype][0],
                                atol=FLASH_TOL[dtype][1], deterministic=True))
    return out


def phase_main(X, truth, Xq, cfg, device, seed) -> tuple[dict, object]:
    """The port's main path through the public estimator, with the launch
    counters set to 0 just before and read just after: on a card every
    kernel ran, ``kmeanspp_seed`` once a restart."""
    from repro_torch.api import KernelKMeans
    from repro_torch.core.metrics import nmi
    from repro_torch.kernels import apnc_assign, apnc_embed, kmeanspp

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    apnc_embed.launches = 0
    apnc_assign.launches = 0
    kmeanspp.launches = 0
    t0 = time.perf_counter()
    est = KernelKMeans(cfg["k"], kernel="rbf", method="nystrom", l=cfg["l"], m=cfg["m"],
                       iters=cfg["iters"], backend="local", block_rows=cfg["block_rows"],
                       random_state=seed, device=device)
    est.fit(X)
    t_fit = time.perf_counter() - t0
    t1 = time.perf_counter()
    pred = est.predict(Xq)
    sync(device)
    t_predict = time.perf_counter() - t1
    launches = dict(apnc_embed=apnc_embed.launches, apnc_assign=apnc_assign.launches,
                    kmeanspp_seed=kmeanspp.launches)
    if device.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"the main path skipped a kernel: {launches}")
    if device.type == "cuda" and launches["kmeanspp_seed"] != est.n_init:
        raise AssertionError(f"k-means++ took {launches['kmeanspp_seed']} launches over "
                             f"{est.n_init} restarts, want one a restart")
    check_labels(est, cfg["k"], X.shape[0])
    if pred.shape != (Xq.shape[0],) or pred.min() < 0 or pred.max() >= cfg["k"]:
        raise AssertionError("predict labels out of range")
    score = nmi(est.labels_, truth)
    if score < 0.5:
        raise AssertionError(f"NMI against the truth is {score}")
    return dict(
        phase="main", n=X.shape[0], d=X.shape[1], k=cfg["k"], l=cfg["l"], m=cfg["m"],
        n_cut=IMAGENET["n"] - X.shape[0] if device.type == "cuda" else None,
        fit_s=t_fit, predict_s=t_predict, predict_rows=Xq.shape[0],
        phases_s=est.phases_, lloyd_iters=est.n_iter_, inertia=est.inertia_,
        gamma=est.kernel_.gamma, nmi=score,
        peak_device_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
        launches=launches,
    ), est


def phase_agreement(X, truth, est, cfg, device, rows=200_000) -> dict:
    """Kernel path against the plain path from the same params and init, on a
    row subset. Three readings:

    * step: along the kernel path's own Lloyd trajectory (k-means++ init),
      each iteration's labels from the assign kernel against its plain version
      at the same Y and centroids. Gated at >= 0.9999 every iteration.
    * truth_init: the whole Lloyd run, kernel path on the card against the
      plain path (the same code on the CPU), both from the per-class means of
      Y. Gated: labels >= 0.9999, inertia within rtol 1e-4.
    * kmeanspp_init: the same comparison from a k-means++ init, the main
      path's own. Gated: inertia within rtol 1e-4, labels >= 0.995. The floor
      is below 0.9999 because a run that has not converged by the iteration
      cap moves its boundaries inside blobs that hold two centroids, and one
      near-tie row flipped early grows into a different boundary later; an
      H100 read 0.997255 (inertia 9.3e-7 apart).
    """
    from repro_torch import embed
    from repro_torch.core.lloyd import centroid_update, kmeanspp_init, lloyd
    from repro_torch.kernels import ops, ref

    k, iters = cfg["k"], cfg["iters"]
    cpu = torch.device("cpu")
    Xs = X[:rows]
    params = est.model_.params
    Yk = embed.transform(params, Xs)
    Yp = embed.transform(params.to(cpu), Xs.to(cpu))
    init_pp = kmeanspp_init(torch.Generator().manual_seed(1), Yk[:1024], k, "l2")
    lab_s = torch.as_tensor(truth[:rows], device=device).long()
    init_truth = torch.zeros((k, Yk.shape[1]), device=device).index_add_(0, lab_s, Yk)
    init_truth /= torch.bincount(lab_s, minlength=k).clamp(min=1).float()[:, None]

    step = []
    C = init_pp
    for _ in range(iters):
        Z, g, lk = ops.apnc_assign(Yk, C, "l2")
        _, _, lr = ref.apnc_assign_ref(Yk, C, "l2")
        step.append(float((lk == lr).float().mean()))
        C = centroid_update(Z, g, C)

    def whole(init):
        rk = lloyd(Yk, k, discrepancy="l2", iters=iters, init=init)
        rp = lloyd(Yp, k, discrepancy="l2", iters=iters, init=init.to(cpu))
        return dict(label_agreement=float((rk.labels.cpu() == rp.labels).float().mean()),
                    inertia_kernel=float(rk.inertia), inertia_plain=float(rp.inertia),
                    inertia_rel_diff=abs(float(rk.inertia) - float(rp.inertia))
                    / abs(float(rp.inertia)),
                    iters_kernel=rk.iters, iters_plain=rp.iters)

    truth_run, pp_run = whole(init_truth), whole(init_pp)
    if device.type == "cuda":
        if min(step) < 0.9999:
            raise AssertionError(f"kernel vs plain at the same centroids: {step}")
        if truth_run["label_agreement"] < 0.9999 or truth_run["inertia_rel_diff"] > 1e-4:
            raise AssertionError(f"kernel vs plain from the same init: {truth_run}")
        if pp_run["label_agreement"] < 0.995 or pp_run["inertia_rel_diff"] > 1e-4:
            raise AssertionError(f"kernel vs plain from the same k-means++ init: {pp_run}")
    return dict(phase="agreement", rows=Xs.shape[0], step_min_agreement=min(step),
                step_agreement=step, truth_init=truth_run, kmeanspp_init=pp_run)


def pinned_store(X, block_rows):
    """A BlockStore over a host copy of X: pinned on a card, so every block's
    copy to the card runs straight from it on the engine's copy stream. (The
    numpy view keeps the pinned tensor alive.)"""
    from repro_torch.stream.blockstore import BlockStore

    host = torch.empty(X.shape, dtype=X.dtype, pin_memory=X.device.type == "cuda")
    host.copy_(X)
    return BlockStore.from_array(host.numpy(), block_rows)


def zero_launches() -> None:
    """Every clustering kernel's launch counter set to 0."""
    from repro_torch.kernels import apnc_assign, apnc_embed, kmeanspp, lloyd_step, rff_embed

    apnc_embed.launches = apnc_assign.launches = rff_embed.launches = kmeanspp.launches = 0
    for name in lloyd_step.launches:
        lloyd_step.launches[name] = 0


def read_launches() -> dict:
    """Every clustering kernel's launch counter, by kernel name."""
    from repro_torch.kernels import apnc_assign, apnc_embed, kmeanspp, lloyd_step, rff_embed

    return dict(apnc_embed=apnc_embed.launches, apnc_assign=apnc_assign.launches,
                rff_embed_block=rff_embed.launches, kmeanspp_seed=kmeanspp.launches,
                **lloyd_step.launches)


#: Every fit and sweep run through fit_measured / sweep_measured, for phase
#: obs: (kind, estimator, data, launches, engine.fused_dispatches).
REPORTS: list[dict] = []


def fit_measured(est, data, device, **fit_kw) -> tuple[object, dict]:
    """Fit with the launch counters and the engine telemetry zeroed just
    before and read just after; also the device-memory rise over the fit."""
    from repro_torch.stream import engine

    sync(device)
    start = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    engine.reset_counters()
    t0 = time.perf_counter()
    est.fit(data, **fit_kw)
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    REPORTS.append(dict(kind="fit", est=est, data=data, launches=launches,
                        fused_dispatches=int(obs.counter("engine.fused_dispatches").value)))
    rise = (torch.cuda.max_memory_allocated(device) - start) if device.type == "cuda" else None
    return est, dict(fit_s=wall, phases_s=est.phases_, launches=launches,
                     engine=dict(engine.COUNTERS), engine_passes=dict(engine.PASS_COUNTS),
                     device_memory_rise_bytes=rise)


def check_labels(est, k, n) -> None:
    lab = est.labels_
    if lab.shape != (n,) or lab.min() < 0 or lab.max() >= k:
        raise AssertionError("fit labels out of range")
    if not np.isfinite(est.inertia_) or not bool(torch.isfinite(est.model_.centroids).all()):
        raise AssertionError("non-finite inertia or centroids")


def agreement(a, b) -> dict:
    return dict(label_agreement=float((a.labels_ == b.labels_).mean()),
                inertia_rel_diff=abs(a.inertia_ - b.inertia_) / abs(b.inertia_))


def equal_centroid_pass(what, X, params, C, bn, embed) -> int:
    """One fused Lloyd pass over X in bn-row blocks against the un-fused
    chain (``embed`` over the whole X, then apnc_assign) at the same
    centroids. On the card both run the same fmaf chains (the sources'
    headers), so any label mismatch fails; returns the count (0)."""
    from repro_torch.kernels import ops

    C = C.contiguous()
    lab_f = torch.cat([ops.fused_lloyd_step(X[i:i + bn], params, C)[2]
                       for i in range(0, X.shape[0], bn)])
    Y = embed(X, params)
    _, _, lab_c = ops.apnc_assign(Y, C, params.discrepancy)
    del Y
    bad = int((lab_f != lab_c).sum())
    if X.device.type == "cuda" and bad:
        raise AssertionError(f"{what}: {bad} of {X.shape[0]} labels differ at equal centroids")
    return bad


def phase_stream(X, truth, Xq, store, local_est, cfg, device, seed) -> tuple[dict, object]:
    """The stream backend at full width: the ImageNet fit over the pinned
    host store, fused_apnc_step once per block per pass. Gated: launches,
    device-memory rise, agreement with the local fit (same phase 1, params
    and init), and at equal centroids one fused pass against the un-fused
    apnc_embed -> apnc_assign chain on the full data, 0 label mismatches."""
    from repro_torch.api import KernelKMeans
    from repro_torch.core.metrics import nmi
    from repro_torch.kernels import ops
    from repro_torch.stream import engine

    est = KernelKMeans(cfg["k"], kernel="rbf", method="nystrom", l=cfg["l"], m=cfg["m"],
                       iters=cfg["iters"], backend="stream", block_rows=cfg["block_rows"],
                       random_state=seed, device=device)
    est, info = fit_measured(est, store, device)
    check_labels(est, cfg["k"], X.shape[0])
    passes = est.n_iter_ + 1
    t1 = time.perf_counter()
    pred = est.predict(Xq)
    sync(device)
    t_predict = time.perf_counter() - t1
    if pred.shape != (Xq.shape[0],) or pred.min() < 0 or pred.max() >= cfg["k"]:
        raise AssertionError("stream predict labels out of range")
    vs_local = agreement(est, local_est)
    same_params = bool(torch.equal(est.model_.params.landmarks, local_est.model_.params.landmarks)
                       and torch.equal(est.model_.params.R, local_est.model_.params.R))

    # One pass with nothing to compute: the host -> device copy alone.
    engine.reset_counters()
    t2 = time.perf_counter()
    engine.map_reduce(store, lambda b: b[:1, :1], lambda acc, _: acc, None, device=device,
                      label="copy_only")
    sync(device)
    copy_pass_s = time.perf_counter() - t2

    # Equal centroids: the fused pass against the un-fused kernel chain.
    bn = cfg["block_rows"]
    mismatches = equal_centroid_pass("fused_apnc_step vs apnc_embed -> apnc_assign", X,
                                     est.model_.params, est.model_.centroids, bn, ops.apnc_embed)
    pass_profile = profile_stream_pass(store, est, device) if device.type == "cuda" else None

    launches = info["launches"]
    if device.type == "cuda":
        need = passes * store.num_blocks
        if launches["fused_apnc_step"] < need:
            raise AssertionError(f"fused_apnc_step ran {launches['fused_apnc_step']} times, "
                                 f"want >= {need}")
        if info["device_memory_rise_bytes"] >= STREAM_RISE_LIMIT:
            raise AssertionError(f"the stream fit raised device memory by "
                                 f"{info['device_memory_rise_bytes']} bytes")
        if vs_local["label_agreement"] < 0.995 or vs_local["inertia_rel_diff"] > 1e-4:
            raise AssertionError(f"stream vs local fit: {vs_local}")
    lloyd_s = est.phases_["lloyd"]
    return dict(
        phase="stream", n=X.shape[0], d=X.shape[1], k=cfg["k"], l=cfg["l"], m=cfg["m"],
        block_rows=bn, num_blocks=store.num_blocks, lloyd_iters=est.n_iter_, passes=passes,
        inertia=est.inertia_, nmi=nmi(est.labels_, truth), predict_s=t_predict,
        predict_rows=Xq.shape[0], per_pass_s=lloyd_s / passes,
        prefetch_stall_s=info["engine"]["prefetch_stall_s"],
        prefetch_stall_per_pass_s=info["engine"]["prefetch_stall_s"] / passes,
        bytes_h2d=info["engine"]["bytes_h2d"], copy_only_pass_s=copy_pass_s,
        copy_only_gb_per_s=X.numel() * 4 / copy_pass_s / 1e9,
        same_params_as_local=same_params, vs_local=vs_local,
        fused_vs_chain=dict(label_mismatches=mismatches, gate=0),
        pass_profile=pass_profile, data_bytes=X.numel() * 4, **info,
    ), est


def phase_rff(X, truth, store, cfg, device, seed) -> tuple[dict, object]:
    """The rff member (m = 128 cosine features, 256 columns) at the same n, d
    and k on the stream backend (fused_rff_step) and the local backend
    (rff_embed_block + apnc_assign), from the same seed. Gated: both kernels
    launched, labels in range, stream vs local labels >= 0.995 with inertia
    within rtol 1e-4, and at the stream fit's centroids one fused_rff_step
    pass against rff_embed_block -> apnc_assign on the full data, 0 label
    mismatches. NMI is printed, not gated: the member approximates the
    kernel."""
    from repro_torch.api import KernelKMeans
    from repro_torch.core.metrics import nmi
    from repro_torch.kernels import ops

    kw = dict(kernel="rbf", method="rff", m=cfg["rff_m"], iters=cfg["iters"],
              block_rows=cfg["block_rows"], random_state=seed, device=device)
    stream, s_info = fit_measured(KernelKMeans(cfg["k"], backend="stream", **kw), store, device)
    local, l_info = fit_measured(KernelKMeans(cfg["k"], backend="local", **kw), X, device)
    for est in (stream, local):
        check_labels(est, cfg["k"], X.shape[0])
    vs_local = agreement(stream, local)
    launches = dict(fused_rff_step=s_info["launches"]["fused_rff_step"],
                    rff_embed_block=s_info["launches"]["rff_embed_block"]
                    + l_info["launches"]["rff_embed_block"])
    if device.type == "cuda":
        if not all(launches.values()):
            raise AssertionError(f"the rff path skipped a kernel: {launches}")
        if vs_local["label_agreement"] < 0.995 or vs_local["inertia_rel_diff"] > 1e-4:
            raise AssertionError(f"rff stream vs local fit: {vs_local}")
    mismatches = equal_centroid_pass("fused_rff_step vs rff_embed_block -> apnc_assign", X,
                                     stream.model_.params, stream.model_.centroids,
                                     cfg["block_rows"], ops.rff_embed)
    return dict(phase="rff", m_half=cfg["rff_m"], m=2 * cfg["rff_m"], launches=launches,
                vs_local=vs_local, fused_vs_chain=dict(label_mismatches=mismatches, gate=0),
                nmi_stream=nmi(stream.labels_, truth),
                nmi_local=nmi(local.labels_, truth), iters=[stream.n_iter_, local.n_iter_],
                inertia=[stream.inertia_, local.inertia_],
                stream=s_info, local=l_info), stream


def sweep_measured(est, data, k_grid, restarts, device, seed, **sweep_kw) -> tuple[object, dict]:
    """est.sweep with the launch counters and the engine telemetry zeroed just
    before and read just after; also the device-memory rise over the sweep."""
    from repro_torch.stream import engine

    sync(device)
    start = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    engine.reset_counters()
    t0 = time.perf_counter()
    res = est.sweep(data, k_grid=list(k_grid), restarts=restarts, seed=seed, **sweep_kw)
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    REPORTS.append(dict(kind="sweep", est=est, data=data, launches=launches,
                        fused_dispatches=int(obs.counter("engine.fused_dispatches").value)))
    rise = (torch.cuda.max_memory_allocated(device) - start) if device.type == "cuda" else None
    return res, dict(sweep_s=wall, phases_s=dict(est.phases_), launches=launches,
                     engine=dict(engine.COUNTERS), engine_passes=dict(engine.PASS_COUNTS),
                     device_memory_rise_bytes=rise)


def staged_blocks(store, params, codec, device):
    """The sweep's staged cache of ``store`` under ``codec`` (the embed pass
    is deterministic, so these are the bytes the sweep streamed)."""
    from repro_torch.policy import ComputePolicy
    from repro_torch.stream.lloyd import stream_embed

    return stream_embed(store, params, policy=ComputePolicy(cache_dtype=codec), device=device)


def check_cache_pass(store, params, C, device) -> tuple[dict, object, object]:
    """At equal centroids C (the f32 sweep's final ones), over every block of
    the int8 cache:

    * exactness of the epilogue: fused_dequant_step and the chain
      dequant_decode -> apnc_assign give the same labels on every row (the
      epilogue repeats apnc_assign.cu), 0 mismatches;
    * the codec bound: every row whose int8 label differs from its label
      over the f32 cache has a gap between its two nearest (sqrt'd l2)
      distances of at most 2 ||b_row|| (b_j = max|col_j| / 254 of its block,
      CacheCodec.error_bound), plus 1e-5 of the distances for the f32
      roundoff of the kernel's own distances.
    """
    from repro_torch.kernels import lloyd_step, ops
    from repro_torch.stream.blockstore import get_codec

    q8 = staged_blocks(store, params, "int8", device)
    f32 = staged_blocks(store, params, "f32", device)
    codec = get_codec("int8")
    chain_mismatch = codec_diff = 0
    worst = 0.0
    for i in range(q8.num_blocks):
        enc = to_device(q8.get_encoded(i), device)
        lab_q = lloyd_step.fused_dequant_step(enc.payload, enc.scale, C, "l2")[2]
        _, _, lab_chain = ops.apnc_assign(lloyd_step.dequant_decode(*enc), C, "l2")
        chain_mismatch += int((lab_q != lab_chain).sum())
        y_host = f32.get(i)
        Y = torch.from_numpy(y_host).to(device)
        _, _, lab_f = ops.apnc_assign(Y, C, "l2")
        rows = torch.nonzero(lab_q != lab_f).flatten()
        if rows.numel():
            codec_diff += int(rows.numel())
            b = torch.from_numpy(np.ascontiguousarray(codec.error_bound(y_host)[0])).to(device)
            d = torch.cdist(Y[rows].double(), C.double())
            top2 = torch.topk(d, 2, dim=1, largest=False).values
            gap = top2[:, 1] - top2[:, 0]
            limit = 2.0 * float(torch.linalg.norm(b.double())) + 1e-5 * top2[:, 1]
            worst = max(worst, float((gap / limit).max()))
    if chain_mismatch:
        raise AssertionError(f"fused_dequant_step vs dequant_decode -> apnc_assign: "
                             f"{chain_mismatch} labels differ")
    if worst > 1.0:
        raise AssertionError(f"an int8 label differs from f32 beyond the codec bound "
                             f"(gap / limit = {worst})")
    return dict(rows=q8.n, chain_label_mismatches=chain_mismatch,
                int8_vs_f32_label_diffs=codec_diff, max_gap_over_codec_limit=worst), q8, f32


def profile_sweep_pass(caches, res, device) -> dict:
    """Where a sweep pass's wall time goes: a copy-only pass over each staged
    cache (the wire bytes alone, through the unpinned store and the pinned
    staging ring), then one Lloyd pass plus the final assign of (a)'s four
    candidates over the int8 cache from their final centroids, traced."""
    from repro_torch.stream import engine
    from repro_torch.sweep.engine import sweep_lloyd

    out = {}
    for codec, cache in caches.items():
        sync(device)
        t0 = time.perf_counter()
        engine.map_reduce(cache, lambda b: None, lambda acc, _: acc, None, device=device,
                          label="copy_only")
        sync(device)
        out[f"copy_only_pass_s_{codec}"] = time.perf_counter() - t0
    inits = [torch.stack([m.centroids for m in row]) for row in res.models]
    run = lambda: sweep_lloyd(caches["int8"], inits, "l2", iters=1, device=device)  # noqa: E731
    run()  # warm-up
    engine.reset_counters()
    _, prof = device_profile(run)
    return dict(passes_traced=2, candidates=sum(len(r) for r in res.models),
                prefetch_stall_ms=engine.COUNTERS["prefetch_stall_s"] * 1e3, **out, **prof)


def phase_sweep(X, truth, store, stream_est, cfg, device, seed) -> tuple[dict, dict]:
    """The embed-once sweep over the pinned store at full n: (a) int8 cache,
    k_grid = cfg's, 2 restarts; (b) the f32 cache at k = 164, 1 restart; (c)
    the same over bf16. Gated: fused_dequant_step launched over every
    compressed cache and not over f32; the wire bytes of every pass exactly
    the payload plus scale bytes (n*m + blocks*m*4 for int8, 2*n*m +
    blocks*4 for bf16, 4*n*m for f32); the device-memory rise; at equal
    centroids, 0 label mismatches between fused_dequant_step and the decode
    -> apnc_assign chain and every int8-vs-f32 label difference inside the
    codec bound; (b) against the stream fit from the same seed >= 0.995; the
    NMI of (a)'s k = 164 winner within 0.01 of (b)'s."""
    from repro_torch.api import ComputePolicy, KernelKMeans
    from repro_torch.core.metrics import nmi

    n, m, bn, k = X.shape[0], cfg["m"], cfg["block_rows"], cfg["k"]
    nb = store.num_blocks
    wire = {"int8": n * m + nb * m * 4, "bf16": 2 * n * m + nb * 4, "f32": 4 * n * m}
    runs, out = {}, dict(phase="sweep", n=n, m=m, k_grid=list(cfg["sweep_k_grid"]),
                         num_blocks=nb, wire_bytes_per_pass=wire)
    plan = (("a_int8", "int8", cfg["sweep_k_grid"], cfg["sweep_restarts"]),
            ("b_f32", "f32", (k,), 1), ("c_bf16", "bf16", (k,), 1))
    for name, codec, grid, restarts in plan:
        est = KernelKMeans(k, kernel="rbf", method="nystrom", l=cfg["l"], m=m,
                           iters=cfg["iters"], backend="stream", block_rows=bn,
                           random_state=seed, device=device,
                           policy=ComputePolicy(cache_dtype=codec))
        res, info = sweep_measured(est, store, grid, restarts, device, seed)
        passes = info["engine_passes"].get("sweep_lloyd", 0)
        pass_bytes = info["engine"]["bytes_h2d"] - X.numel() * 4  # minus the embed pass
        ki = res.k_grid.index(k)
        r_best = int(np.argmin(res.inertia[ki]))
        launched = info["launches"]["fused_dequant_step"]
        runs[name] = (est, res)
        out[name] = dict(
            codec=codec, k_grid=list(grid), restarts=restarts, passes_with_final=passes,
            candidate_iters=_iters(res).tolist(),
            fused_dequant_step_launches=launched,
            bytes_h2d_per_pass=pass_bytes / max(passes, 1),
            bytes_staged=info["engine"]["bytes_staged"],
            compression_ratio=info["engine"]["compression_ratio"],
            nmi_at_k=nmi(res.labels[ki][r_best], truth), best_k=res.best_k,
            inertia_table={str(kk): v for kk, v in res.inertia_table().items()},
            lloyd_s_per_pass=info["phases_s"]["lloyd"] / max(passes, 1), **info)
        if device.type == "cuda":
            if (launched > 0) != (codec != "f32"):
                raise AssertionError(f"sweep {name}: fused_dequant_step ran {launched} times")
            if codec != "f32" and launched < passes * nb:
                raise AssertionError(f"sweep {name}: {launched} launches for {passes} passes")
            if info["device_memory_rise_bytes"] >= STREAM_RISE_LIMIT:
                raise AssertionError(f"sweep {name} raised device memory by "
                                     f"{info['device_memory_rise_bytes']} bytes")
        if pass_bytes != passes * wire[codec]:
            raise AssertionError(f"sweep {name}: {pass_bytes} bytes crossed in {passes} passes, "
                                 f"want {passes} x {wire[codec]}")
    est_b, res_b = runs["b_f32"]
    vs_fit = dict(label_agreement=float((res_b.best_labels == stream_est.labels_).mean()),
                  bitwise_identical=bool(np.array_equal(res_b.best_labels, stream_est.labels_)),
                  centroids_bitwise_identical=bool(torch.equal(
                      res_b.best.centroids, stream_est.model_.centroids)),
                  iters=dict(sweep=est_b.n_iter_, stream_fit=stream_est.n_iter_),
                  inertia_rel_diff=abs(res_b.best_inertia - stream_est.inertia_)
                  / abs(stream_est.inertia_))
    out["b_f32_vs_stream_fit"] = vs_fit
    nmi_gap = abs(out["a_int8"]["nmi_at_k"] - out["b_f32"]["nmi_at_k"])
    out["nmi_gap_int8_vs_f32"] = nmi_gap
    C = est_b.model_.centroids.contiguous()
    cache_check, q8, f32 = check_cache_pass(store, est_b.model_.params, C, device)
    out["equal_centroids"] = cache_check
    if device.type == "cuda":
        out["pass_profile"] = profile_sweep_pass(dict(int8=q8, f32=f32), runs["a_int8"][1],
                                                 device)
    del f32
    if device.type == "cuda":
        if vs_fit["label_agreement"] < 0.995:
            raise AssertionError(f"sweep (b) vs the stream fit: {vs_fit}")
        if nmi_gap > 0.01:
            raise AssertionError(f"NMI of the int8 winner is {nmi_gap} from the f32 one")
    return out, dict(q8=q8, C=C, launches=out["a_int8"]["fused_dequant_step_launches"],
                     a_result=runs["a_int8"][1],
                     lloyd_s=out["a_int8"]["phases_s"]["lloyd"],
                     candidate_passes=int(np.sum(_iters(runs["a_int8"][1]))))


# ------------------------------------------------------------------ shard


#: First-order bound of float32 summation (unit roundoff 2^-24): two orders
#: of summing B block partials differ by at most 2 (B - 1) u sum |partial|.
F32_U = 2.0 ** -24


def shard_equal_centroid_pass(store, params, C, devices, device) -> dict:
    """One Lloyd pass at the centroids ``C`` on the single-device engine and on
    the shards ``devices`` (two logical shards of one card on the card): the
    same plan, the same blocks, each block's (Z, g, labels, cost) bitwise
    the same launch-independent f32 chain; only the order of the block sums
    differs. Gated: 0 label mismatches, g exactly equal (counts below 2^24
    are exact in f32), Z and cost within 2 (B - 1) u sum_b |partial_b| of
    each other."""
    from repro_torch.kernels import ops
    from repro_torch.stream.engine import map_reduce
    from repro_torch.stream.sharded import cross_device_sum, sharded_map_reduce

    k, m = C.shape
    n, B = store.n, store.num_blocks
    fn = ops.lloyd_step_plan(params=params).block_map([C.contiguous()])

    def combine(acc, out):
        return (acc[0] + out[0], acc[1] + out[1], acc[2] + out[3], acc[3] + out[0].abs(),
                acc[4] + out[3].abs())

    def zeros():
        return (torch.zeros((k, m), device=device), torch.zeros((k,), device=device),
                torch.zeros((), device=device), torch.zeros((k, m), device=device),
                torch.zeros((), device=device))

    def writer(lab, shard):
        def emit(i, out):
            lo = shard.row_offset(i)
            lab[lo:lo + out[2].shape[0]].copy_(out[2])
        return emit

    lab1 = torch.full((n,), -1, dtype=torch.int32, device=device)
    lab2 = torch.full((n,), -1, dtype=torch.int32, device=device)
    Z1, g1, c1, absZ, abs_c = map_reduce(store, fn, combine, zeros(), emit=writer(lab1, store),
                                         device=device)
    shards = [store.shard(d, len(devices)) for d in range(len(devices))]
    accs = sharded_map_reduce(shards, [fn] * len(devices), combine,
                              [zeros() for _ in devices], devices=devices,
                              emits=[writer(lab2, s) for s in shards])
    Z2, g2, c2, _, _ = cross_device_sum(accs, devices)
    sync(device)
    z_bound = 2 * (B - 1) * F32_U * absZ
    c_bound = 2 * (B - 1) * F32_U * float(abs_c)
    dz = (Z1 - Z2).abs()
    dc = abs(float(c1) - float(c2))
    out = dict(label_mismatches=int((lab1 != lab2).sum()), g_equal=bool(torch.equal(g1, g2)),
               z_max_abs_diff=float(dz.max()), z_worst_share_of_bound=float(
                   (dz / z_bound.clamp_min(1e-30)).max()),
               z_bound_max=float(z_bound.max()), cost_abs_diff=dc, cost_bound=c_bound,
               bound=f"2 (B - 1) u sum_b |partial_b|, B = {B}, u = 2^-24",
               every_row_assigned=bool((lab2 >= 0).all()))
    if (out["label_mismatches"] or not out["g_equal"] or not out["every_row_assigned"]
            or bool((dz > z_bound).any()) or dc > c_bound):
        raise AssertionError(f"two shards vs one device at equal centroids: {out}")
    return out


def shard_fit(make_est, data, device, **fit_kw) -> tuple[object, dict]:
    """A sharded fit with the launch counters, the engine telemetry and the
    reduction count zeroed just before and read just after; its FitReport
    gated: the trajectory ends at ``inertia_`` and the per-shard block counts
    sum to ``blocks_read``."""
    from repro_torch.stream import engine
    
    est = make_est()
    sync(device)
    zero_launches()
    engine.reset_counters()
    shuffles = obs.counter("reduce.cross_device")
    reductions = shuffles.value
    t0 = time.perf_counter()
    est.fit(data, **fit_kw)
    sync(device)
    wall = time.perf_counter() - t0
    r = est.fit_report_
    if r.inertia_trajectory[-1] != est.inertia_ or \
            sum(r.per_device_blocks.values()) != r.blocks_read:
        raise AssertionError(f"{r.backend} report: {r.summary()}, {r.per_device_blocks}")
    passes = est.n_iter_ + 1
    return est, dict(fit_s=wall, lloyd_s=est.phases_["lloyd"],
                     per_pass_s=est.phases_["lloyd"] / passes, passes=passes,
                     launches=read_launches(), reductions=int(shuffles.value - reductions),
                     per_device_blocks=r.per_device_blocks, blocks_read=r.blocks_read)


def time_reduce(run, device) -> dict:
    """One ``reduce.cross_device`` call: host us a call (the launches queued,
    the card synchronized before and after) and, on a card, event-timed ms a
    call over 200."""
    run()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(200):
        run()
    host = (time.perf_counter() - t0) / 200 * 1e6
    sync(device)
    return dict(host_us_per_call=host,
                event_ms_per_call=cuda_ms(run, 200) if device.type == "cuda" else None)


def _bitwise(a, b) -> bool:
    return bool(np.array_equal(a.labels_, b.labels_) and a.inertia_ == b.inertia_
                and torch.equal(a.model_.centroids.cpu(), b.model_.centroids.cpu())
                and a.fit_report_.inertia_trajectory == b.fit_report_.inertia_trajectory
                and a.fit_report_.centroid_shifts == b.fit_report_.centroid_shifts)


def phase_shard(X, truth, store, main_est, stream_est, rff_stream_est, sweep_res, cfg, device,
                seed) -> dict:
    """The sharded stream, the pool scheduler and the shard_map backend over
    phase stream's pinned store, from the same seed (the same phase 1 params
    and init): (a) a mesh of the visible cards (one on a one-card machine),
    bit for bit phase stream's fit; (b) two logical shards of cuda:0, each
    with its own producer, thread and CUDA stream: an equal-centroid pass
    against one device (`shard_equal_centroid_pass`), the full fit (labels
    >= 0.995 phase stream's), ``sstep=2`` (one shuffle every second
    iteration and at the last, labels >= 0.98 phase stream's), the rff
    member (>= 0.995 phase rff's stream fit); the pool scheduler
    fault-free and with worker 1
    killed after 40 blocks (a quarter of the store's at the rehearsal's size)
    and worker 0 delayed 1 ms a block, bit for bit;
    the sharded mini-batch (one epoch); (c) shard_map on nystrom and rff
    over the resident X split in two (labels >= 0.995 phase main's local
    fit, and phase rff's stream fit); (d) the int8 sweep, k_grid and
    restarts of phase sweep (a), on the two shards (its k = 164 winner's
    labels >= 0.995 phase sweep's). Every clustering kernel of the path is
    launched, each run with the counters zeroed just before and read just
    after. Times are host clock, synchronized: "2 logical shards on one
    card", no cross-card number."""
    from repro_torch.api import ComputePolicy, KernelKMeans
    from repro_torch.core.distributed import distributed_embed, distributed_lloyd
    from repro_torch.core.lloyd import lloyd
    from repro_torch.core.metrics import nmi
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.pool import ChaosPlan, inject
    from repro_torch.stream.lloyd import minibatch_lloyd
    from repro_torch.stream.sharded import cross_device_sum, shard_devices, shard_names

    on_card = device.type == "cuda"
    k, bn = cfg["k"], cfg["block_rows"]
    common = dict(kernel="rbf", method="nystrom", l=cfg["l"], m=cfg["m"], iters=cfg["iters"],
                  block_rows=bn, random_state=seed)
    cards = make_mesh((torch.cuda.device_count(), 1), ("data", "model")) if on_card \
        else make_mesh((1, 1), ("data", "model"), devices=[device])
    two = make_mesh((2, 1), ("data", "model"), devices=[device] * 2)
    logical = shard_devices(two)
    out = dict(phase="shard", card=nvidia_smi() if on_card else "cpu",
               layout="2 logical shards on one card" if on_card else "2 cpu shards",
               cards_mesh=[str(d) for d in shard_devices(cards)])
    launches: dict[str, int] = {}

    def add(info):
        for name, v in info["launches"].items():
            launches[name] = launches.get(name, 0) + v

    # (a) the mesh of the visible cards
    d1, info = shard_fit(lambda: KernelKMeans(k, backend="stream_shard", mesh=cards, **common),
                         store, device)
    add(info)
    check_labels(d1, k, X.shape[0])
    out["cards"] = dict(info, devices=len(shard_devices(cards)),
                        bitwise_phase_stream=_bitwise(d1, stream_est),
                        label_agreement=float((d1.labels_ == stream_est.labels_).mean()))
    if len(shard_devices(cards)) == 1 and not out["cards"]["bitwise_phase_stream"]:
        raise AssertionError("a one-card mesh is not bit for bit phase stream's fit")

    # (b) two logical shards
    out["equal_centroids"] = shard_equal_centroid_pass(
        store, stream_est.model_.params, stream_est.model_.centroids, logical, device)
    lock, info = shard_fit(lambda: KernelKMeans(k, backend="stream_shard", mesh=two, **common),
                           store, device)
    add(info)
    check_labels(lock, k, X.shape[0])
    pair = [(lock.model_.centroids.clone(), torch.ones((k,), device=device),
             torch.ones((), device=device))] * 2
    out["lockstep"] = dict(
        info, vs_phase_stream=agreement(lock, stream_est), nmi=nmi(lock.labels_, truth),
        nmi_phase_stream=nmi(stream_est.labels_, truth),
        per_pass_s_one_device=out["cards"]["per_pass_s"],
        reduce_cross_device=time_reduce(lambda: cross_device_sum(pair, logical), device))
    if on_card:  # one pass each way, traced, in turns: one, two, two, one
        runs = [("one_device", [device]), ("two_shards", logical)] * 2
        profiles = {name: [] for name, _ in runs[:2]}
        for name, devs in runs[:2] + runs[2:][::-1]:
            profiles[name].append(profile_stream_pass(store, lock, device, devs))
        out["pass_profile"] = profiles
    if not set(shard_names(logical)) <= set(lock.fit_report_.per_device_blocks):
        raise AssertionError(f"per-shard counters: {lock.fit_report_.per_device_blocks}")
    if info["reductions"] != lock.n_iter_:
        raise AssertionError(f"{info['reductions']} reductions in {lock.n_iter_} iterations")

    s2, info = shard_fit(lambda: KernelKMeans(k, backend="stream_shard", mesh=two,
                                              policy=ComputePolicy(sstep=2), **common),
                         store, device)
    add(info)
    check_labels(s2, k, X.shape[0])
    out["sstep2"] = dict(info, vs_phase_stream=agreement(s2, stream_est),
                         nmi=nmi(s2.labels_, truth))
    # The s-step rule shuffles at every second iteration and at the last one.
    if info["reductions"] != -(-s2.n_iter_ // 2):
        raise AssertionError(f"sstep=2: {info['reductions']} reductions in {s2.n_iter_} "
                             "iterations")
    if on_card and out["sstep2"]["vs_phase_stream"]["label_agreement"] < 0.98:
        raise AssertionError(f"phase shard sstep2: {out['sstep2']['vs_phase_stream']}")

    rff_kw = dict(common, method="rff", m=cfg["rff_m"])
    del rff_kw["l"]
    rff2, info = shard_fit(lambda: KernelKMeans(k, backend="stream_shard", mesh=two, **rff_kw),
                           store, device)
    add(info)
    check_labels(rff2, k, X.shape[0])
    out["rff"] = dict(info, vs_phase_rff_stream=agreement(rff2, rff_stream_est))

    pool, info = shard_fit(lambda: KernelKMeans(k, backend="stream_shard", mesh=two,
                                                scheduler="pool", **common), store, device)
    add(info)
    before = obs.snapshot("pool.")
    kill_after = min(40, store.num_blocks // 4)  # mid-first-pass at any size
    with inject(ChaosPlan().kill(1, after_blocks=kill_after).delay(0, 0.001)):
        chaos, chaos_info = shard_fit(
            lambda: KernelKMeans(k, backend="stream_shard", mesh=two, scheduler="pool",
                                 **common), store, device)
    add(chaos_info)
    seen = obs.delta(before, obs.snapshot("pool."))
    out["pool"] = dict(info, vs_lockstep=agreement(pool, lock),
                       bitwise_phase_stream=_bitwise(pool, stream_est),
                       per_pass_s_lockstep=out["lockstep"]["per_pass_s"])
    if not out["pool"]["bitwise_phase_stream"]:  # its host merge is one device's order
        raise AssertionError(f"the pool fit is not phase stream's: {out['pool']}")
    out["chaos"] = dict(chaos_info, bitwise_fault_free=_bitwise(chaos, pool),
                        plan=f"kill worker 1 after {kill_after} blocks, delay worker 0 by "
                             "1 ms a block",
                        **{name: seen.get(f"pool.{name}", 0) for name in (
                            "tasks_requeued", "worker_deaths", "duplicates_dropped",
                            "tasks_stolen", "tasks_speculated")})
    if not out["chaos"]["bitwise_fault_free"] or not out["chaos"]["worker_deaths"]:
        raise AssertionError(f"the chaos pool fit: {out['chaos']}")

    ctx = KernelKMeans(k, backend="stream", device=device, **common)._prepare(
        store, seed, device, "stream")
    zero_launches()
    t0 = time.perf_counter()
    mb = minibatch_lloyd(store, k, coeffs=ctx.params, init=ctx.inits[0], devices=logical,
                         epochs=1)
    sync(device)
    add(dict(launches=read_launches()))
    mb_s = time.perf_counter() - t0
    mb1 = minibatch_lloyd(store, k, coeffs=ctx.params, init=ctx.inits[0], device=device,
                          epochs=1)
    out["minibatch"] = dict(seconds=mb_s, nmi=nmi(mb.labels, truth),
                            nmi_one_device=nmi(mb1.labels, truth), inertia=mb.inertia)
    if mb.labels.min() < 0 or not np.isfinite(mb.inertia) or \
            out["minibatch"]["nmi"] < out["minibatch"]["nmi_one_device"] - 0.15:
        raise AssertionError(f"the sharded mini-batch: {out['minibatch']}")

    # (c) shard_map on the resident X
    for name, kw, ref in (("shard_map_nystrom", common, main_est),
                          ("shard_map_rff", rff_kw, rff_stream_est)):
        est, info = shard_fit(lambda kw=kw: KernelKMeans(k, backend="shard_map", mesh=two, **kw),
                              X, device)
        add(info)
        check_labels(est, k, X.shape[0])
        out[name] = dict(fit_s=info["fit_s"], lloyd_s=info["lloyd_s"], launches=info["launches"],
                         reductions=info["reductions"], iters=est.n_iter_,
                         vs_reference_fit=agreement(est, ref), nmi=nmi(est.labels_, truth))
    # Lloyd alone, from phase 1's init over the embedded X: the two shards'
    # loop (every iteration) against the local backend's (until fixed).
    Ys = distributed_embed(two, X, ctx.params)
    Y = torch.cat(Ys)
    distributed_lloyd(two, Ys, ctx.inits[0], k=k, discrepancy="l2", iters=1)
    sync(device)
    t0 = time.perf_counter()
    distributed_lloyd(two, Ys, ctx.inits[0], k=k, discrepancy="l2", iters=cfg["iters"])
    sync(device)
    t_shards = (time.perf_counter() - t0) / cfg["iters"]
    t0 = time.perf_counter()
    local = lloyd(Y, k, discrepancy="l2", iters=cfg["iters"], init=ctx.inits[0])
    sync(device)
    out["shard_map_nystrom"].update(
        lloyd_s_per_iter=t_shards,
        local_lloyd_s_per_iter=(time.perf_counter() - t0) / max(local.iters, 1),
        local_lloyd_iters=local.iters)
    del Ys, Y

    # (d) the int8 sweep on the two shards
    est = KernelKMeans(k, backend="stream_shard", mesh=two,
                       policy=ComputePolicy(cache_dtype="int8"), **common)
    zero_launches()
    t0 = time.perf_counter()
    res = est.sweep(store, k_grid=list(cfg["sweep_k_grid"]), restarts=cfg["sweep_restarts"],
                    seed=seed)
    sync(device)
    info = dict(launches=read_launches())
    add(info)
    ki = res.k_grid.index(k)
    r = int(np.argmin(sweep_res.inertia[ki]))  # phase sweep's winner at k, restart r here too
    out["sweep_int8"] = dict(
        seconds=time.perf_counter() - t0, launches=info["launches"], phases_s=dict(est.phases_),
        k_grid=list(res.k_grid), restarts=res.restarts, best=[res.best_k, res.best_restart],
        best_phase_sweep=[sweep_res.best_k, sweep_res.best_restart],
        label_agreement_at_k=float((res.labels[ki][r] == sweep_res.labels[ki][r]).mean()),
        inertia_rel_diff_at_k=abs(res.inertia[ki][r] - sweep_res.inertia[ki][r])
        / abs(sweep_res.inertia[ki][r]))

    out["launches"] = launches
    path = ("apnc_embed", "apnc_assign", "fused_apnc_step", "fused_rff_step",
            "rff_embed_block", "fused_dequant_step")
    if on_card:
        if not all(launches.get(name) for name in path):
            raise AssertionError(f"phase shard skipped a kernel: {launches}")
        for what, a in (("lockstep", out["lockstep"]["vs_phase_stream"]),
                        ("rff", out["rff"]["vs_phase_rff_stream"]),
                        ("shard_map_nystrom", out["shard_map_nystrom"]["vs_reference_fit"]),
                        ("shard_map_rff", out["shard_map_rff"]["vs_reference_fit"]),
                        ("sweep_int8", dict(label_agreement=out["sweep_int8"][
                            "label_agreement_at_k"]))):
            if a["label_agreement"] < 0.995:
                raise AssertionError(f"phase shard {what}: {a}")
    return out


def strict_manifest(path) -> dict:
    """A checkpoint step's manifest, parsed by a strict JSON parser (NaN,
    Infinity and -Infinity refused)."""
    def reject(const):
        raise AssertionError(f"non-strict JSON constant {const} in {path}")

    return json.loads((Path(path) / "manifest.json").read_text(), parse_constant=reject)


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def failing_store(store, fail_after):
    """``store`` behind a get() that raises once ``fail_after`` reads have
    been served: an ingest crash mid-fit, at the seam a real one hits (the
    engine's producer thread)."""
    import threading

    from repro_torch.stream.blockstore import BlockStore

    count, lock = [0], threading.Lock()

    def get(i):
        with lock:
            count[0] += 1
            if count[0] > fail_after:
                raise RuntimeError("injected ingest crash")
        return store.get(i)

    return BlockStore(get, n=store.n, d=store.d, block_rows=store.block_rows)


def save_load_round(name, est, Xq, root, device) -> dict:
    """est.save, KernelKMeans.load onto the device, and predict of the
    held-out rows: the labels, centroids and params bit for bit the
    in-memory estimator's; the manifest strict JSON."""
    from repro_torch.api import KernelKMeans

    d = Path(root) / name
    sync(device)
    t0 = time.perf_counter()
    step_dir = est.save(d)
    save_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    loaded = KernelKMeans.load(d, device=device)
    sync(device)
    load_s = time.perf_counter() - t1
    manifest = strict_manifest(step_dir)
    want, got = est.predict(Xq), loaded.predict(Xq)
    p0, p1 = est.model_.params, loaded.model_.params
    tensors_equal = all(torch.equal(getattr(p0, f), getattr(p1, f)) for f in
                        ("landmarks", "R", "W") if hasattr(p0, f))
    out = dict(save_s=save_s, load_s=load_s, artifact_bytes=dir_bytes(d),
               method=manifest["meta"]["clustering"]["embedding"]["method"],
               predict_bitwise=bool(np.array_equal(got, want)),
               centroids_bitwise=bool(torch.equal(loaded.model_.centroids, est.model_.centroids)),
               params_bitwise=tensors_equal, manifest_strict_json=True,
               on_device=str(loaded.model_.centroids.device))
    if not (out["predict_bitwise"] and out["centroids_bitwise"] and tensors_equal):
        raise AssertionError(f"save/load of the {name} model: {out}")
    return out


def crash_and_resume(make_est, store, ref, fail_after, root, device, per_pass_s) -> dict:
    """A fit with checkpoint_dir over ``store`` whose reads fail after
    ``fail_after`` blocks, then the refit over ``store`` with the same
    directory: labels, iterations and inertia bit for bit ``ref``'s (the
    uninterrupted fit), at least one state adopted and at least one
    iteration skipped. Also the seconds of each state save and their share
    of a pass of the uninterrupted fit."""
    from repro_torch.distributed import checkpoint as ckpt

    saves: list[float] = []
    real_save = ckpt.save_lloyd_state

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        out = real_save(*args, **kw)
        saves.append(time.perf_counter() - t0)
        return out

    t0 = time.perf_counter()
    try:
        make_est().fit(failing_store(store, fail_after), checkpoint_dir=root)
    except RuntimeError as e:
        if "injected ingest crash" not in str(e):
            raise
    else:
        raise AssertionError("the fit over the failing store did not fail")
    crashed_s = time.perf_counter() - t0
    skipped = ckpt.latest_step(Path(root) / "restart_0" / ckpt.LLOYD_STATE_DIR)
    if not skipped:
        raise AssertionError("the crash landed before the first published iteration")
    ckpt.reset_counters()
    with patched(ckpt, "save_lloyd_state", timed_save):
        est, info = fit_measured(make_est(), store, device, checkpoint_dir=root)
    counters = dict(ckpt.COUNTERS)
    out = dict(iterations_skipped=skipped, crashed_fit_s=crashed_s, resumed_fit_s=info["fit_s"],
               iters=est.n_iter_, counters=counters, state_saves=len(saves),
               state_save_s=dict(mean=float(np.mean(saves)), max=float(np.max(saves)))
               if saves else None,
               state_save_share_of_pass=float(np.mean(saves)) / per_pass_s if saves else None,
               labels_bitwise=bool(np.array_equal(est.labels_, ref.labels_)),
               n_iter_equal=est.n_iter_ == ref.n_iter_,
               inertia_bitwise=est.inertia_ == ref.inertia_,
               centroids_bitwise=bool(torch.equal(est.model_.centroids, ref.model_.centroids)),
               launches=info["launches"])
    if counters["ckpt_resumes"] < 1 or not all(
            out[key] for key in ("labels_bitwise", "n_iter_equal", "inertia_bitwise",
                                 "centroids_bitwise")):
        raise AssertionError(f"the resumed fit is not the uninterrupted one: {out}")
    return out


def partial_fit_equal_state(est_dir, block, device) -> dict:
    """Two estimators warm-started from the same saved model, the default
    route (the kernels on the card) and kernels=False (the plain versions),
    each given one block: labels equal but for near ties (check_near_ties, as
    phase agreement), and, with each near-tie row moved to the plain route's
    cluster, g equal and Z and the centroids within check_step's tolerances
    (rtol 1e-4, atol 1e-4 of the largest |value|)."""
    from repro_torch import embed
    from repro_torch.api import ComputePolicy, KernelKMeans
    from repro_torch.core.lloyd import centroid_update

    kern = KernelKMeans.load(est_dir, device=device)
    plain = KernelKMeans.load(est_dir, device=device, policy=ComputePolicy(kernels=False))
    C = kern.model_.centroids
    kern.partial_fit(block)
    plain.partial_fit(block)
    lab_k = torch.from_numpy(kern.labels_).to(device)
    lab_p = torch.from_numpy(plain.labels_).to(device)
    Y = embed.transform(plain.model_.params, block.to(device), ComputePolicy(kernels=False))
    rows, gap = check_near_ties("partial_fit kernel vs plain", Y, C, lab_k, lab_p, 1e-3, 1e-4)
    (Zk, gk, _), (Zp, gp, _) = kern._pf_state, plain._pf_state
    Zk, gk = Zk.clone(), gk.clone()
    for r in rows.tolist():  # the near-tie rows as the plain route assigned them
        Zk[lab_k[r]] -= Y[r]
        Zk[lab_p[r]] += Y[r]
        gk[lab_k[r]] -= 1
        gk[lab_p[r]] += 1
    if not torch.equal(gk, gp):
        raise AssertionError("partial_fit kernel vs plain: g differs at equal labels")
    z_err = check_close("partial_fit Z", Zk, Zp, 1e-4, 1e-4 * float(Zp.abs().max()))
    Cp = plain.model_.centroids
    c_err = check_close("partial_fit centroids", centroid_update(Zk, gk, C), Cp, 1e-4,
                        1e-4 * float(Cp.abs().max()))
    return dict(rows=block.shape[0], label_mismatches=int(rows.numel()), max_rel_gap=gap,
                g_equal=True, z_max_abs_err=z_err, centroids_max_abs_err=c_err,
                inertia=[kern.inertia_, plain.inertia_])


def phase_persist(X, truth, Xq, store, local_est, rff_est, stream_est, stream_per_pass_s,
                  cfg, device, seed) -> dict:
    """Checkpoints, resume and the online path at full n, under one temporary
    directory removed at the end, failing or not:

    * save_load: the local fit of phase main and the rff stream fit of phase
      rff saved, loaded onto the card and predicting the held-out rows bit
      for bit (apnc_embed, rff_embed_block);
    * stream_resume: phase stream's fit with checkpoint_dir over the store
      failing mid-iteration 2, then refit: bit for bit phase stream's fit;
    * minibatch_resume: the same for a 3-epoch minibatch fit (decay 0.9),
      the crash inside epoch 2, against one uninterrupted minibatch fit;
    * sweep_resume: the int8 sweep at k = 164 with checkpoint_dir, twice:
      the second loads the staged Y.bin and runs no embedding pass, its
      passes in fused_dequant_step over the memmap, the result bit for bit
      the first's; load_any_model serves the winner;
    * partial_fit: the store's blocks streamed from a cold start, then the
      kernel route against the plain one at equal state."""
    import shutil
    import tempfile

    from repro_torch.api import ComputePolicy, KernelKMeans
    from repro_torch.core.metrics import nmi
    from repro_torch.distributed import checkpoint as ckpt

    k, bn, nb, n = cfg["k"], cfg["block_rows"], store.num_blocks, X.shape[0]
    base = dict(kernel="rbf", method="nystrom", l=cfg["l"], m=cfg["m"], iters=cfg["iters"],
                block_rows=bn, random_state=seed, device=device)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_persist_"))
    parts: list[dict] = []
    try:
        zero_launches()
        save_load = dict(local=save_load_round("local", local_est, Xq, root, device),
                         rff=save_load_round("rff", rff_est, Xq, root, device))
        parts.append(read_launches())

        # Reads: the reservoir pass, iteration 1, then half of iteration 2.
        stream_resume = crash_and_resume(
            lambda: KernelKMeans(k, backend="stream", **base), store, stream_est,
            2 * nb + nb // 2, root / "stream", device, stream_per_pass_s)
        parts.append(stream_resume["launches"])

        mb = dict(base, backend="minibatch", epochs=3, decay=0.9)
        mb_ref, mb_info = fit_measured(KernelKMeans(k, **mb), store, device)
        parts.append(mb_info["launches"])
        minibatch_resume = crash_and_resume(
            lambda: KernelKMeans(k, **mb), store, mb_ref, 2 * nb + nb // 2,
            root / "minibatch", device, mb_info["phases_s"]["lloyd"] / (mb_ref.n_iter_ + 1))
        minibatch_resume["uninterrupted_fit_s"] = mb_info["fit_s"]
        parts.append(minibatch_resume["launches"])

        runs = []
        for _ in range(2):
            est = KernelKMeans(k, backend="stream", policy=ComputePolicy(cache_dtype="int8"),
                               **base)
            res, info = sweep_measured(est, store, [k], 1, device, seed,
                                       checkpoint_dir=root / "sweep")
            runs.append((est, res, info))
            parts.append(info["launches"])
        (e1, r1, i1), (e2, r2, i2) = runs
        stage = root / "sweep" / "embed_stage"
        y_bin = (stage / "Y.bin").stat().st_size
        scales = (stage / "scales.npy").stat().st_size
        served = ckpt.load_any_model(root / "sweep", device=device)
        passes2 = i2["engine_passes"].get("sweep_lloyd", 0)
        sweep_resume = dict(
            cache_embedding_passes=[i1["engine_passes"].get("cache_embedding", 0),
                                    i2["engine_passes"].get("cache_embedding", 0)],
            resumed=[r1.resumed, r2.resumed],
            inertia_bitwise=bool(np.array_equal(r1.inertia, r2.inertia)),
            labels_bitwise=bool(np.array_equal(r1.labels[0][0], r2.labels[0][0])),
            centroids_bitwise=bool(torch.equal(r1.best.centroids, r2.best.centroids)),
            load_any_model_predicts_like_best=bool(torch.equal(
                served.predict(Xq, device=device), r2.best.predict(Xq, device=device))),
            y_bin_bytes=y_bin, scales_bytes=scales,
            f32_over_staged=4.0 * n * cfg["m"] / (y_bin + scales),
            stage_save_s=e1.phases_.get("stage_save"), stage_load_s=e2.phases_.get("stage_load"),
            result_save_s=[e1.phases_.get("result_save"), e2.phases_.get("result_save")],
            sweep_s=[i1["sweep_s"], i2["sweep_s"]], phases_s=[i1["phases_s"], i2["phases_s"]],
            passes_with_final=passes2,
            fused_dequant_step_launches=[i1["launches"]["fused_dequant_step"],
                                         i2["launches"]["fused_dequant_step"]])
        if (sweep_resume["cache_embedding_passes"] != [1, 0]
                or sweep_resume["resumed"] != [False, True]
                or not all(sweep_resume[key] for key in (
                    "inertia_bitwise", "labels_bitwise", "centroids_bitwise",
                    "load_any_model_predicts_like_best"))):
            raise AssertionError(f"the resumed sweep: {sweep_resume}")
        if y_bin != n * cfg["m"]:
            raise AssertionError(f"Y.bin holds {y_bin} bytes, want {n * cfg['m']}")
        if device.type == "cuda" and i2["launches"]["fused_dequant_step"] < passes2 * nb:
            raise AssertionError(f"the resumed sweep launched fused_dequant_step "
                                 f"{i2['launches']['fused_dequant_step']} times in {passes2} passes")

        zero_launches()
        cold = KernelKMeans(k, **base)
        t0 = time.perf_counter()
        cold.partial_fit(store.get(0))
        sync(device)
        first_s = time.perf_counter() - t0
        parts.append(read_launches())
        zero_launches()
        t1 = time.perf_counter()
        for i in range(1, nb):
            cold.partial_fit(store.get(i))
        sync(device)
        per_call_ms = (time.perf_counter() - t1) / max(nb - 1, 1) * 1e3
        warm = read_launches()
        parts.append(warm)
        per_call = {name: v / max(nb - 1, 1) for name, v in warm.items() if v}
        if cold.model_.meta.rows_seen != n:
            raise AssertionError(f"partial_fit saw {cold.model_.meta.rows_seen} of {n} rows")
        if device.type == "cuda" and (warm["apnc_embed"], warm["apnc_assign"]) != (nb - 1, nb - 1):
            raise AssertionError(f"partial_fit launches over {nb - 1} calls: {warm}")
        zero_launches()
        equal_state = partial_fit_equal_state(root / "local", X[:bn], device)
        parts.append(read_launches())
        partial_fit = dict(calls=nb, rows_seen=cold.model_.meta.rows_seen,
                           first_call_s=first_s, ms_per_call=per_call_ms,
                           launches_per_call=per_call, nmi=nmi(cold.predict(X), truth),
                           kernel_vs_plain=equal_state)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {name: sum(p.get(name, 0) for p in parts) for name in parts[0]}
    if device.type == "cuda":
        for name in ("apnc_embed", "apnc_assign", "rff_embed_block", "fused_apnc_step",
                     "fused_dequant_step"):
            if not launches[name]:
                raise AssertionError(f"phase persist never launched {name}: {launches}")
    return dict(phase="persist", n=n, k=k, m=cfg["m"], num_blocks=nb, save_load=save_load,
                stream_resume=stream_resume, minibatch_resume=minibatch_resume,
                sweep_resume=sweep_resume, partial_fit=partial_fit, launches=launches,
                temp_dir_removed=not root.exists())


def timed(device, fn) -> tuple[object, dict]:
    """``fn()`` with its wall seconds (synchronised at both ends), the peak
    device memory while it ran, and that peak's rise above what was
    allocated before (the earlier phases' data stays on the card)."""
    sync(device)
    start = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return out, dict(seconds=time.perf_counter() - t0, peak_device_bytes=peak,
                     peak_rise_bytes=None if peak is None else peak - start)


def card_vs_cpu(name, run, seed, Xs, kern, k, bc, gated=True, tie_rtol=1e-4,
                mismatch_share=1e-3) -> dict:
    """One baseline on ``Xs`` where it lies (the card) and on a CPU copy from
    the same seed (its draws are the CPU generator's either way): labels
    equal outside near ties (each differing row's two clusters within
    ``tie_rtol`` * the row's largest |d2| under the CPU run's distances), the
    objective within rtol 1e-4. ``gated=False`` only reports."""
    from repro_torch.core import baselines as B

    Xc = Xs.cpu()
    a, b = run(Xs), run(Xc)
    lab_a, lab_b = a.labels.cpu().long(), b.labels.long()
    rows = torch.nonzero(lab_a != lab_b).flatten()
    gap_rel = 0.0
    if rows.numel():
        d2 = B._final_d2(name, seed, Xc, kern, k, l=bc["l"], m=bc["rff_m"],
                         iters=bc["iters"])[rows]
        gap = (d2.gather(1, lab_a[rows, None]) - d2.gather(1, lab_b[rows, None])).abs()
        gap_rel = float((gap[:, 0] / d2.abs().max(dim=1).values).max())
    obj_a, obj_b = float(a.objective), float(b.objective)
    rel = abs(obj_a - obj_b) / abs(obj_b)
    out = dict(label_mismatches=int(rows.numel()), largest_tie_gap_rel=gap_rel,
               objective_rel_diff=rel, gated=gated)
    if gated and (rows.numel() > mismatch_share * Xs.shape[0] or not gap_rel <= tie_rtol
                  or not rel <= 1e-4):
        raise AssertionError(f"{name}, card vs CPU: {out}")
    return out


def approx_lockstep(seed, Xs, kern, k, bc, diff_rtol=1e-3) -> dict:
    """approx_kkm's steps on the card and on the CPU from the same labels at
    every step (the CPU's): its pseudo-inverse may amplify roundoff by up to
    1 / (10 l eps), so a free run's near tie at one step grows into other
    labels at the next, and the runs are held step by step instead. Gated
    at each step: the card's distances within ``diff_rtol`` of the largest
    |d2| of the CPU's, and every row whose argmin differs a tie within twice
    that row's largest card-vs-CPU difference."""
    from repro_torch.core import baselines as B

    card = B._approx_inputs(seed, Xs, kern, k, bc["l"])
    cpu = B._approx_inputs(seed, Xs.cpu(), kern, k, bc["l"])
    labels = cpu[4]
    worst, flips = 0.0, 0
    for step in range(bc["iters"]):
        d2_card = B._approx_d2(*card[:4], labels.to(Xs.device), k).cpu()
        d2_cpu = B._approx_d2(*cpu[:4], labels, k)
        diff = (d2_card - d2_cpu).abs()
        worst = max(worst, float(diff.max() / d2_cpu.abs().max()))
        lab_card, labels = torch.argmin(d2_card, dim=-1), torch.argmin(d2_cpu, dim=-1)
        rows = torch.nonzero(lab_card != labels).flatten()
        flips += int(rows.numel())
        gap = (d2_cpu[rows, lab_card[rows]] - d2_cpu[rows, labels[rows]]).abs()
        if worst > diff_rtol or bool((gap > 2 * diff[rows].max(dim=1).values).any()):
            raise AssertionError(f"approx_kkm step {step}, card vs CPU: distances differ by "
                                 f"{worst} of the largest, {rows.numel()} labels")
    return dict(steps=bc["iters"], largest_d2_diff_rel=worst, near_tie_flips=flips)


def phase_baselines(cfg, device, seed) -> dict:
    """The paper's Table 2 on the card: exact kernel k-means on the full
    Gram, approx_kkm, rff_kmeans, svd_rff_kmeans and two_stage, then the
    legacy fit_predict / predict, on the imagenet-50k stand-in (self-tuned
    rbf). Gated: every NMI in [0, 1] and every objective finite;
    fit_predict launching apnc_embed and one apnc_assign a Lloyd step (and
    one for the final assignment); the legacy predict equal to
    ClusterModel.predict bit for bit; at small_n rows each baseline on the
    card against the same function on the CPU (`card_vs_cpu`; approx_kkm
    step by step, `approx_lockstep`)."""
    from repro_torch.api.model import ClusterModel
    from repro_torch.core import baselines as B
    from repro_torch.core import kkmeans
    from repro_torch.core.kernels_fn import self_tuned_rbf
    from repro_torch.core.metrics import nmi
    from repro_torch.data.synthetic import gaussian_blobs, paper_standin

    bc = cfg["baselines"]
    held = bc["held_out"]
    if bc["dataset"]:
        ds = PAPER_DATASETS[bc["dataset"]]
        n, d, k = ds.n, ds.d, ds.k
        (X_all, y_all, _), made = timed(device, lambda: paper_standin(
            bc["dataset"], seed, n_override=n + held, device=device))
    else:
        n, d, k = bc["n"], cfg["d"], cfg["k"]
        (X_all, y_all), made = timed(device, lambda: gaussian_blobs(
            seed, n + held, d, k, separation=cfg["separation"], warp=True, device=device))
    X, Xq = X_all[:n], X_all[n:]
    truth, truth_q = y_all[:n].cpu().numpy(), y_all[n:].cpu().numpy()
    kern = self_tuned_rbf(X, seed=seed)

    K, gram = timed(device, lambda: kern.gram(X, X))
    gram["bytes"] = K.numel() * K.element_size()
    exact, exact_t = timed(device, lambda: B.exact_kernel_kmeans(seed, K, kern.diag(X), k,
                                                                 bc["iters"]))
    del K
    exact_t["seconds_per_lloyd_iteration"] = exact_t["seconds"] / (bc["iters"] + 1)
    runs = dict(
        approx_kkm=lambda Xr: B.approx_kkm(seed, Xr, kern, k, bc["l"], bc["iters"]),
        rff_kmeans=lambda Xr: B.rff_kmeans(seed, Xr, kern.gamma, k, bc["rff_m"], bc["iters"]),
        svd_rff_kmeans=lambda Xr: B.svd_rff_kmeans(seed, Xr, kern.gamma, k, bc["rff_m"],
                                                   bc["iters"]),
        two_stage=lambda Xr: B.two_stage(seed, Xr, kern, k, bc["l"], bc["iters"]))
    results = dict(exact_kernel_kmeans=(exact, exact_t))
    for name, run in runs.items():
        results[name] = timed(device, lambda run=run: run(X))

    cfg_legacy = kkmeans.APNCConfig(method="nystrom", l=bc["l"], m=bc["m"], iters=bc["iters"],
                                    n_init=1)
    zero_launches()
    (res, coeffs), fit_t = timed(device, lambda: kkmeans.fit_predict(
        seed, X, kern, k, cfg_legacy, device=device))
    fit_launches = read_launches()
    pred, predict_t = timed(device, lambda: kkmeans.predict(Xq, coeffs, res.centroids,
                                                            device=device))
    model = ClusterModel(params=coeffs, centroids=res.centroids, inertia=res.inertia)
    predict_equal = bool(torch.equal(pred, model.predict(Xq, device=device)))

    out = dict(phase="baselines", dataset=bc["dataset"] or "gaussian_blobs(warp=True)",
               n=n, d=d, k=k, held_out=held, gamma=kern.gamma, data_s=made["seconds"],
               gram=gram, runs={})
    for name, (r, t) in results.items():
        objective = float(r.objective)
        out["runs"][name] = dict(nmi=nmi(r.labels.cpu(), truth),
                                 nmi_vs_exact=nmi(r.labels.cpu(), exact.labels.cpu()),
                                 objective=objective, **t)
    out["runs"]["fit_predict"] = dict(
        nmi=nmi(res.labels.cpu(), truth), nmi_vs_exact=nmi(res.labels.cpu(), exact.labels.cpu()),
        objective=float(res.inertia), lloyd_iters=res.iters, launches=fit_launches, **fit_t)
    out["predict"] = dict(rows=held, nmi=nmi(pred.cpu(), truth_q), equals_cluster_model=predict_equal,
                          **predict_t)
    for name, r in out["runs"].items():
        if not (0.0 <= r["nmi"] <= 1.0 and 0.0 <= r["nmi_vs_exact"] <= 1.0
                and np.isfinite(r["objective"])):
            raise AssertionError(f"baseline {name}: {r}")
    if not 0.0 <= out["predict"]["nmi"] <= 1.0 or not predict_equal:
        raise AssertionError(f"the legacy predict: {out['predict']}")
    if device.type == "cuda" and (fit_launches["apnc_embed"] < 1
                                  or fit_launches["apnc_assign"] != res.iters + 1):
        raise AssertionError(f"fit_predict launches over {res.iters} Lloyd steps: {fit_launches}")

    Xs = X[:bc["small_n"]]
    Ks = lambda Xr: B.exact_kernel_kmeans(seed, kern.gram(Xr, Xr), kern.diag(Xr), k,  # noqa: E731
                                          bc["iters"])
    out["card_vs_cpu"] = dict(n=Xs.shape[0], **{
        name: card_vs_cpu(name, run, seed, Xs, kern, k, bc, gated=name != "approx_kkm")
        for name, run in dict(exact_kernel_kmeans=Ks, **runs).items()})
    out["card_vs_cpu"]["approx_kkm_lockstep"] = approx_lockstep(seed, Xs, kern, k, bc)
    return out


def check_report(rec, device) -> dict:
    """One fit's or sweep's FitReport, gated: it is ``model_.report``, its
    trajectory ends at ``inertia_``; over a store its blocks are the store's
    blocks times its passes, all on one device; a fit over raw X blocks
    moves n * d * 4 bytes a pass and counts one ``engine.fused_dispatches``
    a block a pass, each a fused kernel's launch on the card."""
    from repro_torch.stream import engine
    from repro_torch.stream.blockstore import BlockStore

    est, data = rec["est"], rec["data"]
    r = est.fit_report_
    what = f"{rec['kind']} {r.backend if r else '?'}"
    if r is None or est.model_.report is not r:
        raise AssertionError(f"{what}: no fit_report_ on the estimator and its model")
    if r.inertia_trajectory[-1] != est.inertia_:
        raise AssertionError(f"{what}: trajectory ends at {r.inertia_trajectory[-1]}, "
                             f"inertia_ is {est.inertia_}")
    passes = sum(r.pass_counts.values())
    out = dict(kind=rec["kind"], backend=r.backend, summary=r.summary(), passes=passes,
               blocks_read=r.blocks_read, bytes_h2d=r.bytes_h2d,
               per_device_blocks=r.per_device_blocks,
               fused_dispatches=rec["fused_dispatches"])
    if not isinstance(data, BlockStore):
        if r.blocks_read or passes:
            raise AssertionError(f"{what}: a resident fit streamed {r.blocks_read} blocks")
        return out
    if r.blocks_read != data.num_blocks * passes or \
            r.per_device_blocks != {engine.device_name(device): r.blocks_read}:
        raise AssertionError(f"{what}: {r.blocks_read} blocks in {passes} passes of "
                             f"{data.num_blocks}, by device {r.per_device_blocks}")
    if rec["kind"] == "fit":
        out["bytes_h2d_per_pass"] = r.bytes_h2d / max(passes, 1)
        if r.bytes_h2d != passes * data.n * data.d * 4:
            raise AssertionError(f"{what}: {r.bytes_h2d} bytes in {passes} passes")
        fused = rec["launches"]["fused_apnc_step"] + rec["launches"]["fused_rff_step"]
        out["fused_launches"] = fused
        if rec["fused_dispatches"] != r.blocks_read or (
                device.type == "cuda" and rec["fused_dispatches"] != fused):
            raise AssertionError(f"{what}: {rec['fused_dispatches']} fused dispatches, "
                                 f"{fused} launches, {r.blocks_read} blocks")
    return out


def phase_obs(X, store, main_est, stream_per_pass_s, stream_est, cfg, device, seed) -> dict:
    """The reports and the trace: every fit and sweep the earlier phases ran
    carries a FitReport (`check_report`); phase stream's fit once more with
    tracing on, its Chrome trace written to a temporary directory and read
    back (the lanes main and producer:<device>, one h2d span a block a pass,
    the phase spans, labels bit for bit phase stream's); its per-pass time
    beside phase stream's (not gated); and the roofline join of phase
    stream's report under the H100's peaks."""
    import shutil
    import tempfile

    from repro_torch.api import KernelKMeans
    from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS, lloyd_step_record
    from repro_torch.stream import engine

    reports = [check_report(dict(kind="fit", est=main_est, data=X, launches={},
                                 fused_dispatches=0), device)]
    reports += [check_report(rec, device) for rec in REPORTS]

    obs.clear_trace()
    obs.enable_tracing()
    try:
        est, info = fit_measured(
            KernelKMeans(cfg["k"], kernel="rbf", method="nystrom", l=cfg["l"], m=cfg["m"],
                         iters=cfg["iters"], backend="stream", block_rows=cfg["block_rows"],
                         random_state=seed, device=device), store, device)
    finally:
        obs.disable_tracing()
    report = check_report(REPORTS[-1], device)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_trace_"))
    try:
        path = obs.write_trace(root / "stream_fit.trace.json")
        trace_bytes = path.stat().st_size
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_spans = len(obs.TRACER.spans())
    obs.clear_trace()
    lanes = sorted(e["args"]["name"] for e in events if e["ph"] == "M")
    names = [e["name"] for e in events if e["ph"] == "X"]
    passes = report["passes"]
    counts = {name: names.count(name) for name in sorted(set(names))}
    want_lanes = sorted(["main", f"producer:{engine.device_name(device)}"])
    phases = [f"phase.{p}" for p in ("reservoir", "embed_fit", "seed", "lloyd")]
    same_labels = bool(np.array_equal(est.labels_, stream_est.labels_))
    if (lanes != want_lanes or counts.get("h2d") != store.num_blocks * passes
            or not all(counts.get(p) for p in phases) or not same_labels):
        raise AssertionError(f"the traced stream fit: lanes {lanes}, spans {counts}, "
                             f"{passes} passes, labels as phase stream's: {same_labels}")
    traced_per_pass = info["phases_s"]["lloyd"] / passes

    n, d, l, m, k = store.n, store.d, cfg["l"], cfg["m"], cfg["k"]
    rec_block = lloyd_step_record(n=cfg["block_rows"], d=d, l=l, m=m, k=k)
    rec_pass = lloyd_step_record(n=n, d=d, l=l, m=m, k=k)
    stream_report = stream_est.fit_report_
    return dict(
        phase="obs", reports=reports, report_count=len(reports),
        traced_stream_fit=dict(
            lanes=lanes, span_counts=counts, spans=n_spans, trace_bytes=trace_bytes,
            passes=passes, labels_as_phase_stream=same_labels, report=report,
            per_pass_s=traced_per_pass, untraced_per_pass_s=stream_per_pass_s,
            tracing_overhead=traced_per_pass / stream_per_pass_s - 1.0),
        roofline=dict(
            peak_flops=PEAK_FLOPS, hbm_bytes_per_s=HBM_BW,
            join_block_record=obs.join_fit_roofline(stream_report, rec_block),
            join_pass_record=obs.join_fit_roofline(stream_report, rec_pass),
            record_block=rec_block, record_pass=rec_pass))


def serve_launches_gate(what, launches, flushes, extra, device) -> None:
    """On a card, the service launched an embedding kernel (``apnc_embed`` or
    ``rff_embed_block``) once a flush and ``apnc_assign`` as often, plus
    ``extra`` launches of each outside the flushes (warm-ups and replays)."""
    embeds = launches["apnc_embed"] + launches["rff_embed_block"]
    if device.type == "cuda" and not embeds == launches["apnc_assign"] == flushes + extra:
        raise AssertionError(f"{what}: {flushes} flushes (+{extra}), launches {launches}")


def serve_run(what, stats, n_req, device, launches, extra) -> dict:
    """One cluster_serve run's gates and summary: every admitted request
    answered, 0 mismatches, offered = admitted + shed, no errors, and the
    launches of its flushes, warm-ups and replays."""
    admitted = stats.get("admitted", n_req)
    flushes = stats["metrics"]["serve.batch_size"]["count"]
    if (stats["mismatches"] or stats["served"] != admitted
            or admitted + stats["shed"] != n_req or stats.get("errors", 0)):
        raise AssertionError(f"{what}: {stats}")
    serve_launches_gate(what, launches, flushes, extra, device)
    keep = ("served", "shed", "wall_s", "req_per_s", "p50_ms", "p90_ms", "p99_ms",
            "mismatches", "admitted", "errors", "by_version", "swap_s", "swap_at")
    return dict({key: stats[key] for key in keep if key in stats}, flushes=flushes,
                batch_size=stats["metrics"]["serve.batch_size"], launches=launches,
                e2e_latency_ms=stats["metrics"]["serve.e2e_latency_ms"])


def phase_serve(Xq, est, rff_est, cfg, device, seed) -> dict:
    """The online assignment service (``repro_torch.serving``) on phase
    main's Nystrom model and phase rff's model, both saved to a temporary
    directory (removed) and served from disk, ``max_batch`` rows a flush:

    * (a) ``cluster_serve.main`` closed loop over its own request log:
      every request answered, 0 mismatches against ``core.kkmeans.predict``
      over the whole log;
    * (b) the same, open loop at half of (a)'s rate, hot-swapped to the rff
      model halfway: every admitted request answered, offered = admitted +
      shed, 0 mismatches against each version's model, both versions
      served;
    * (c) both models by name in one ``ModelRegistry``, over phase main's
      held-out rows: ``submit_wait`` closed loop alternating the name, then
      ``run_open_loop`` on "nystrom" at 4 x (a)'s rate through a tier with
      256 requests in flight at most: each label equal to its model's
      ``core.kkmeans.predict``, offered = admitted + shed, every admitted
      request answered, no errors.

    On a card each flush launches one embedding kernel (``apnc_embed`` or
    ``rff_embed_block``) and one ``apnc_assign`` (``ops.assign_labels``), and
    the gates count them against the flushes, with each run's warm-ups and
    replays. ``process_fn`` times one full flush of each model (host clock,
    ending in the labels' copy back)."""
    import shutil
    import tempfile

    from repro_torch.core.kkmeans import predict
    from repro_torch.launch import cluster_serve
    from repro_torch.serving import ModelRegistry, ServingTier, make_process_fn, run_open_loop

    sc = cfg["serve"]
    n_req, mb = sc["requests"], sc["micro_batch"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    try:
        est.save(root / "nystrom")
        rff_est.save(root / "rff")
        common = ["--requests", str(n_req), "--micro-batch", str(mb), "--max-delay-ms",
                  str(sc["max_delay_ms"]), "--k", str(cfg["k"]), "--seed", str(seed),
                  "--stats-every", "0", "--ckpt", str(root / "nystrom")]
        if device.type == "cpu":
            common += ["--device", "cpu"]
        zero_launches()
        stats = cluster_serve.main(common)
        # one warm-up at register, one replay launch over the whole log
        run_a = serve_run("(a) closed loop", stats, n_req, device, read_launches(), 2)
        rate_b = sc["open_rate"] * run_a["req_per_s"]
        zero_launches()
        stats = cluster_serve.main(common + ["--rate", str(rate_b), "--swap-ckpt",
                                             str(root / "rff"), "--swap-after",
                                             str(n_req // 2)])
        # two warm-ups (register, swap), two replays (one a version)
        run_b = serve_run("(b) open loop, hot swap", stats, n_req, device, read_launches(), 4)
        run_b["target_req_per_s"] = rate_b
        if set(run_b["by_version"]) != {"1", "2"} or (
                device.type == "cuda" and not run_b["launches"]["rff_embed_block"] > 2):
            raise AssertionError(f"(b) the swap: {run_b}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    X_host = Xq.cpu().numpy()
    models = {"nystrom": est.model_, "rff": rff_est.model_}
    refs = {name: predict(X_host, m.params, m.centroids, device=device).cpu().numpy()
            for name, m in models.items()}
    registry = ModelRegistry(max_batch=mb, device=device)
    for name, m in models.items():
        registry.register(name, m)
    names = list(models)

    def mismatches(responses, name_of):
        return sum(1 for r in responses if not r.ok or r.model != name_of(r.request_id)
                   or r.label != refs[r.model][r.request_id % len(X_host)])

    obs.reset_metrics("serve.")
    zero_launches()
    t0 = time.perf_counter()
    with ServingTier(registry, max_delay_s=sc["max_delay_ms"] / 1e3) as tier:
        futs = [tier.submit_wait(i, X_host[i % len(X_host)], names[i % 2])
                for i in range(n_req)]
        closed = [f.result() for f in futs]
    wall = time.perf_counter() - t0
    launches = read_launches()
    snap = obs.snapshot("serve.")
    bad = mismatches(closed, lambda i: names[i % 2])
    if bad or len(closed) != n_req:
        raise AssertionError(f"(c) two models, closed loop: {bad} mismatches")
    serve_launches_gate("(c) closed loop", launches, snap["serve.batch_size"]["count"], 0,
                        device)
    lat = np.asarray([r.latency_s for r in closed]) * 1e3
    run_c = dict(closed=dict(
        served=len(closed), mismatches=bad, wall_s=wall, req_per_s=n_req / wall,
        p50_ms=float(np.percentile(lat, 50)), p90_ms=float(np.percentile(lat, 90)),
        p99_ms=float(np.percentile(lat, 99)), flushes=snap["serve.batch_size"]["count"],
        by_model={name: int(snap[f"serve.model.{name}.served"]) for name in names},
        launches=launches))

    obs.reset_metrics("serve.")
    zero_launches()
    rate_c = sc["overload"] * run_a["req_per_s"]
    tier = ServingTier(registry, max_delay_s=sc["max_delay_ms"] / 1e3,
                       max_inflight=sc["max_inflight"]).start()
    try:
        rep = run_open_loop(tier, X_host, qps=rate_c, n_requests=n_req, model="nystrom",
                            seed=seed)
    finally:
        tier.stop()
    launches = read_launches()
    snap = obs.snapshot("serve.")
    bad = mismatches(rep.responses, lambda i: "nystrom")
    if (bad or rep.errors or rep.admitted + rep.shed != rep.offered
            or len(rep.responses) != rep.admitted):
        raise AssertionError(f"(c) overload: {bad} mismatches, {rep.errors} errors, "
                             f"{rep.offered} offered, {rep.admitted} admitted, {rep.shed} "
                             f"shed, {len(rep.responses)} answered")
    serve_launches_gate("(c) overload", launches, snap["serve.batch_size"]["count"], 0, device)
    run_c["overload"] = dict(
        target_req_per_s=rate_c, offered=rep.offered, admitted=rep.admitted, shed=rep.shed,
        shed_rate=rep.shed_rate, errors=rep.errors, mismatches=bad,
        answered_req_per_s=rep.rows_per_s, duration_s=rep.duration_s,
        p50_ms=rep.latency_ms(50), p99_ms=rep.latency_ms(99),
        flushes=snap["serve.batch_size"]["count"], launches=launches, metrics=snap)

    # One full flush of each model through its closure: the copy in, the two
    # launches and the labels' copy back (the flush's one synchronisation).
    flush_ms = {}
    for name, m in models.items():
        process = make_process_fn(m, max_batch=mb, device=device)
        rows = X_host[:mb]
        process(rows)
        t0 = time.perf_counter()
        for _ in range(sc["flush_iters"]):
            process(rows)
        flush_ms[name] = (time.perf_counter() - t0) / sc["flush_iters"] * 1e3
    total = {name: sum(r["launches"][name] for r in (run_a, run_b, run_c["closed"],
                                                     run_c["overload"]))
             for name in ("apnc_embed", "rff_embed_block", "apnc_assign")}
    return dict(phase="serve", requests=n_req, micro_batch=mb, d=Xq.shape[1], k=cfg["k"],
                a_closed_loop=run_a, b_open_loop_swap=run_b, c_two_models=run_c,
                process_fn_ms_per_flush=flush_ms, launches=total)


# ------------------------------------------------------------ the examples

#: Phase examples: the kernels each of the port's documented scripts must
#: launch on the card. A script that launched none of one took the plain
#: route where its path names the kernel.
EXAMPLE_KERNELS = {
    "torch_quickstart": ("apnc_embed", "apnc_assign"),
    "torch_stream_quickstart": ("fused_apnc_step",),
    "torch_covtype_scale": ("apnc_embed", "fused_dequant_step"),
    "torch_activation_clustering": ("apnc_embed", "apnc_assign", "flash_attention_bhsd"),
    "torch_train_lm": ("flash_attention_bhsd",),
}
#: The NMI bars of tests/test_torch_examples.py, on the card too: each
#: reference script's own CPU NMI at its CI size, less 0.02 (ROADMAP.md's
#: rule on the draws).
EXAMPLE_NMI_BAR = {"torch_quickstart": 1.000 - 0.02, "torch_stream_quickstart": 1.000 - 0.02,
                   "torch_covtype_scale": 0.975 - 0.02,
                   "torch_activation_clustering": 0.124 - 0.02}


def load_example(name):
    """``examples/<name>.py`` of this checkout as a module (nothing runs)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_example(name, out) -> None:
    """The invariants a script prints: identical predictions after the
    save/load round trip, served labels equal to the fit labels on the
    fitted rows, a falling loss, an NMI at or above its bar."""
    nmi_bar = EXAMPLE_NMI_BAR.get(name)
    if "replay_identical" in out and not (out["replay_identical"] == out["served_match_fit"]
                                          == out["served"]):
        raise AssertionError(f"{name}: round trip or serving differs: {out}")
    if "loss_first" in out and not (np.isfinite(out["loss_last"])
                                    and out["loss_last"] < out["loss_first"]):
        raise AssertionError(f"{name}: loss {out['loss_first']} -> {out['loss_last']}")
    if "last_step" in out and out["last_step"] != out["steps"] - 1:
        raise AssertionError(f"{name}: stopped at step {out['last_step']} of {out['steps']}")
    if nmi_bar is not None and not out["nmi"] >= nmi_bar:
        raise AssertionError(f"{name}: NMI {out['nmi']} under {nmi_bar}")


def phase_examples(cfg, device) -> dict:
    """Each ``examples/torch_*.py``'s ``main(argv)`` in this process, at its
    defaults on the card (its CI size in the rehearsal), train_lm's
    ``--ckpt`` in a temporary directory removed after. Every kernel's launch
    counter is zeroed just before a script and read just after; on the card
    each script must have launched the kernels ``EXAMPLE_KERNELS`` names.
    What a script prints is kept in its record."""
    import io
    import shutil
    import tempfile

    flash = _flash()
    info = dict(phase="examples", scripts={})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        for name, argv in cfg["examples"].items():
            argv = list(argv) + ([] if device.type == "cuda" else ["--device", "cpu"])
            if name == "torch_train_lm":
                argv += ["--ckpt", os.path.join(tmp, "train_lm")]
            module = load_example(name)
            sync(device)
            zero_launches()
            flash.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                out = module.main(argv)
            sync(device)
            seconds = time.perf_counter() - t0
            launches = dict(read_launches(), flash_attention_bhsd=flash.launches)
            info["scripts"][name] = dict(argv=argv, seconds=seconds, launches=launches,
                                         printed=printed.getvalue().splitlines(), result=out,
                                         nmi_bar=EXAMPLE_NMI_BAR.get(name))
            check_example(name, out)
            missing = [k for k in EXAMPLE_KERNELS[name] if not launches[k]]
            if device.type == "cuda" and missing:
                raise AssertionError(f"{name} launched no {missing}: {launches}")
            if device.type != "cuda" and any(launches.values()):
                raise AssertionError(f"{name} counted launches on the CPU: {launches}")
    except BaseException:
        print(json.dumps(info, default=str), file=sys.stderr, flush=True)  # the scripts that ran
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    info["temp_dir_removed"] = not os.path.exists(tmp)
    info["launches"] = {k: sum(s["launches"][k] for s in info["scripts"].values())
                        for k in ("apnc_embed", "apnc_assign", "fused_apnc_step",
                                  "fused_dequant_step", "flash_attention_bhsd")}
    return info


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` set to ``value`` inside the block, restored after."""
    kept = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, kept)


def plain_attention():
    """Every layer's prefill attention through ``flash_attention_ref``
    instead of the kernel, inside the block."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention

    return patched(attention, "_flash_attention",
                   lambda q, k, v, window: ref.flash_attention_ref(q, k, v, window))


def f32_cache():
    """Prefill keeps its k, v in f32 for the cache (the reference and the port
    store bf16) inside the block."""
    from repro_torch.models import attention

    bf16_prefill = attention.fwd_prefill

    def prefill(p, cfg, policy, h, positions, heads=None):
        _, k, v = attention._project_qkv(p, cfg, policy, h, positions)
        y, _ = bf16_prefill(p, cfg, policy, h, positions, heads)
        return y, {"k": k, "v": v}

    return patched(attention, "fwd_prefill", prefill)


def _step_key(cfg) -> str:
    return "codes" if cfg.frontend == "audio_codes" else "tokens"


def teacher_forced(model, cfg, policy, prompt: dict, tokens, kv_int8=False):
    """Logits (gen + 1, B, ...) of a prefill over the ``prompt`` batch and
    one decode step per position of ``tokens`` (B, gen), or codes (B, K,
    gen), fed those whatever the logits say."""
    from repro_torch.launch import serve
    from repro_torch.train.step import make_decode_step

    key = _step_key(cfg)
    decode = make_decode_step(cfg, policy)  # one device or a mesh (a MeshLM)
    with torch.inference_mode():
        S, gen = serve.prompt_length(cfg, prompt), tokens.shape[-1]
        logits, cache = serve.prefill(model, cfg, policy, prompt, S + gen, kv_int8=kv_int8)
        steps = [logits]
        for i in range(gen):
            logits, cache = decode(model, {key: tokens[..., i:i + 1]}, cache, S + i)
            steps.append(logits)
    return torch.stack(steps)


def decode_vs_full(model, cfg, policy, batch: dict, full_last) -> float:
    """max |decode of the batch's last position over a prefill of the rest -
    the full prefill's last logits|."""
    key = _step_key(cfg)
    rest = dict(batch, **{key: batch[key][..., :-1]})
    step = teacher_forced(model, cfg, policy, rest, batch[key][..., -1:])[1]
    return float((step.float() - full_last.float()).abs().max())


def phase_lm_serve(cfg, device, seed) -> dict:
    """The LM serving path: qwen1.5-0.5b (full width and depth on the card;
    reduced in the rehearsal) from a seeded random init, f32 params and
    math, a synthetic 4 x 4,096-token prompt, 32 greedy decode steps through
    ``serve.generate`` over a bf16 KV cache, the kernel launch count zeroed
    just before and read just after. Gated on a card:

    * every prefill layer launched ``flash_attention_bhsd``, once (no other
      route of the prefill attention);
    * the same model and tokens with the plain attention in every layer
      (``flash_attention_ref``), both teacher-forced on the kernel run's
      tokens: prefill and every decode step's logits within
      1e-4 * max|logits| (greedy agreement is reported, not gated: on a
      random init the top-2 gap can be below that);
    * decode == prefill: a prefill over the prompt's first S - 1 tokens and
      one decode step of the last, against the full prefill's last logits.
      The reference's bound, 2e-3 (tests/test_models_smoke.py), is held
      where the reference holds it, on the reduced model (2 x 16 tokens, on
      the card), and at full width with the cache in f32, which isolates
      the decode path. At full width with the bf16 cache the rounding of
      the cached k, v alone moves the logits by ~2.6e-3 (an H100 read
      2.59e-3 against 7.8e-6 with the f32 cache), so that reading is gated
      at 2e-2, the reference's bound for the coarser int8 cache;
    * the same decode over an int8 KV cache within 2e-2 of the bf16 cache's
      logits (the reference's bound);
    * finite logits, tokens inside the vocabulary, TF32 off.
    """
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.kernels import flash_attention
    from repro_torch.launch import serve
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: the projections must be f32 as in the reference")
    arch = get_arch(cfg["lm_arch"])
    mcfg = reduced(arch) if cfg["lm_reduced"] else arch
    B, S, gen = cfg["lm_batch"], cfg["lm_prompt"], cfg["lm_gen"]
    policy = TEST_POLICY
    t0 = time.perf_counter()
    model = lm.init(torch.Generator(device=device).manual_seed(seed), mcfg, policy, device)
    prompt = torch.as_tensor(synthetic_batch(mcfg, 0, B, S)["tokens"], device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params = lm.param_count(model)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    flash_attention.launches = 0
    res = serve.generate(model, mcfg, policy, {"tokens": prompt}, gen)
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    logits = res.logits
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    if res.tokens.shape != (B, gen) or int(res.tokens.min()) < 0 \
            or int(res.tokens.max()) >= mcfg.vocab_size:
        raise AssertionError("generated tokens out of range")

    t1 = time.perf_counter()
    with plain_attention():
        plain = teacher_forced(model, mcfg, policy, {"tokens": prompt}, res.tokens)
    sync(device)
    plain_s = time.perf_counter() - t1
    scale = float(logits.abs().max())
    vs_plain = float((logits - plain).abs().max())
    plain_tokens = plain[:-1].argmax(dim=-1).T
    dvp = dict(bf16_cache=decode_vs_full(model, mcfg, policy, {"tokens": prompt}, logits[0]))
    with f32_cache():
        dvp["f32_cache"] = decode_vs_full(model, mcfg, policy, {"tokens": prompt}, logits[0])
    small = reduced(arch)
    small_model = lm.init(torch.Generator(device=device).manual_seed(seed), small, policy, device)
    small_prompt = torch.as_tensor(synthetic_batch(small, 0, 2, 16)["tokens"], device=device)
    with torch.inference_mode():
        small_full, _ = lm.forward_prefill(small_model, small, policy, {"tokens": small_prompt})
    dvp["reduced_bf16_cache"] = decode_vs_full(small_model, small, policy, {"tokens": small_prompt},
                                                  small_full)
    dvp_limits = dict(bf16_cache=2e-2, f32_cache=2e-3, reduced_bf16_cache=2e-3)
    int8 = teacher_forced(model, mcfg, policy, {"tokens": prompt}, res.tokens, kv_int8=True)
    int8_vs_bf16 = float((int8 - logits).abs().max())
    profile = profile_serve(model, mcfg, policy, prompt, res.tokens) \
        if device.type == "cuda" else None
    kv_bytes = 2 * mcfg.num_layers * B * (S + gen) * mcfg.num_kv_heads \
        * mcfg.resolved_head_dim * 2
    if device.type == "cuda":
        if launches != mcfg.num_layers:
            raise AssertionError(f"flash_attention_bhsd ran {launches} times in one prefill of "
                                 f"{mcfg.num_layers} layers")
    if vs_plain > 1e-4 * scale:
        raise AssertionError(f"kernel vs plain logits differ by {vs_plain} (max |logit| {scale})")
    if any(dvp[key] > limit for key, limit in dvp_limits.items()):
        raise AssertionError(f"decode vs prefill: {dvp} (limits {dvp_limits})")
    if int8_vs_bf16 > 2e-2:
        raise AssertionError(f"int8 vs bf16 KV cache: {int8_vs_bf16}")
    return dict(
        phase="lm_serve", arch=mcfg.name, layers=mcfg.num_layers, d_model=mcfg.d_model,
        heads=mcfg.num_heads, kv_heads=mcfg.num_kv_heads, head_dim=mcfg.resolved_head_dim,
        d_ff=mcfg.d_ff, vocab=mcfg.vocab_size, batch=B, prompt=S, gen=gen, seed=seed,
        params=n_params, param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
        init_s=init_s, prefill_s=res.prefill_s, decode_s=res.decode_s,
        decode_ms_per_step=res.decode_s / gen * 1e3,
        decode_tokens_per_s=B * gen / res.decode_s,
        flash_attention_launches=launches, peak_device_bytes=peak, kv_cache_bytes=kv_bytes,
        first_tokens=res.tokens[:, :8].tolist(), logits_abs_max=scale,
        plain_prefill_and_decode_s=plain_s,
        vs_plain=dict(max_abs_diff=vs_plain, limit=1e-4 * scale,
                      greedy_agreement=float((plain_tokens == res.tokens).float().mean())),
        decode_vs_prefill=dict(max_abs_diff=dvp, limit=dvp_limits),
        int8_vs_bf16=dict(max_abs_diff=int8_vs_bf16, limit=2e-2),
        profile=profile,
    )


# ---------------------------------------------------------------- LM training

#: Tolerance of the attention gradients against autograd through the plain
#: version, a multiple of each gradient's max |g|. Both sides do the same f32
#: arithmetic (the Function's backward does not read the kernel's output);
#: they differ only in the order of their sums, over at most S = 4,096 terms:
#: about sqrt(S) u = 3.8e-6 for rounding of random sign, S u = 2.4e-4 at worst
#: (u = 2^-24). 1e-4 sits between.
ATTN_GRAD_RTOL = 1e-4
#: One full-width step, attention through the Function against the plain
#: version under autograd: the loss within rtol 2e-4 and each gradient leaf
#: within 2e-3 * its max |g|. The forward attention differs by up to the
#: reference's kernel tolerance (rtol 2e-4, FLASH_TOL), and a gradient's
#: relative error carries that of every activation on its path: ten times it.
STEP_LOSS_RTOL = 2e-4
STEP_GRAD_RTOL = 2e-3
#: The reference's decode-vs-full bound for an MoE arch (tests/test_models_smoke.py).
MOE_DECODE_TOL = 5e-2


def _flash():
    from repro_torch.kernels import flash_attention

    return flash_attention


def train_parts(mcfg, lr, total, seed, device, warmup=2):
    """A seeded model at ``mcfg``, its AdamW state (f32 moments unless the
    arch says otherwise) and ``make_train_step`` with warmup_cosine(warmup,
    total=total), f32 params and math."""
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.step import make_train_step

    model = lm.init(torch.Generator(device=device).manual_seed(seed), mcfg, TEST_POLICY, device)
    opt_cfg = adamw.AdamWConfig(lr=lr, moments_dtype=mcfg.moments_dtype)
    step = make_train_step(mcfg, TEST_POLICY, opt_cfg,
                           lambda s: warmup_cosine(s, warmup=warmup, total=total))
    return model, adamw.init(model, opt_cfg), step


def train_steps(step_fn, model, opt, data, steps, device) -> tuple[list, list, list]:
    """``steps`` train steps over ``data``; each step's host time ends on a
    device sync. Returns (losses, seconds, metrics)."""
    losses, times, metrics = [], [], []
    for _ in range(steps):
        batch = next(data)
        t0 = time.perf_counter()
        model, opt, m = step_fn(model, opt, batch)
        sync(device)
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        metrics.append({k: float(v) for k, v in m.items()})
    return losses, times, metrics


def train_step_split(run, vocab) -> dict:
    """One traced train step: wall ms, device busy share, and the device ms
    split between attention forward (the flash kernel), attention backward
    (everything under the Function's backward node), the optimizer (under an
    ``lm_train.optimizer`` range), cross-entropy (kernels of ops with a
    vocab-wide operand: the head product, logsumexp, gather and their
    gradients), the other GEMMs, and the rest (norms, RoPE, SwiGLU,
    residuals, the embedding). Each kernel is attributed through the op that
    launched it and that op's parents."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import adamw

    update = adamw.update

    def traced_update(*a, **kw):
        with torch.profiler.record_function("lm_train.optimizer"):
            return update(*a, **kw)

    torch.cuda.synchronize()
    with patched(adamw, "update", traced_update), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = dict(gemm=0.0, attention_forward=0.0, attention_backward=0.0, cross_entropy=0.0,
                 optimizer=0.0, other=0.0)
    for evt in prof.events():
        kernels = getattr(evt, "kernels", None) or []
        if not kernels:
            continue
        names, e = [], evt
        while e is not None:
            names.append(e.name)
            e = e.cpu_parent
        shapes = [s for s in (evt.input_shapes or []) if isinstance(s, (list, tuple))]
        for kern in kernels:
            kname = kern.name.lower()
            if any("FlashAttentionBackward" in n for n in names):
                part = "attention_backward"
            elif "flash_kernel" in kname:
                part = "attention_forward"
            elif "lm_train.optimizer" in names:
                part = "optimizer"
            elif any(vocab in s for s in shapes) and "embedding" not in evt.name:
                part = "cross_entropy"
            elif any(w in kname for w in ("gemm", "cutlass", "xmma", "sm90")):
                part = "gemm"
            else:
                part = "other"
            split[part] += kern.duration / 1e3
    busy = sum(split.values())
    if not busy:
        return dict(wall_ms=wall * 1e3, split_ms="not measured",
                    note="the profiler linked no kernel to the op that launched it")
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy, device_busy_share=busy / (wall * 1e3),
                idle_share=1 - busy / (wall * 1e3), split_ms=split,
                split_share={k: v / (wall * 1e3) for k, v in split.items()})


def dense_training(cfg, device, seed) -> dict:
    """(a) qwen1.5-0.5b unreduced (24 layers, d_model 1,024, vocab 151,936,
    remat full), f32 params, moments and math, AdamW lr 3e-3 with
    warmup_cosine(2, 20), batch 4 x 2,048 from ``batch_iterator``, 20 steps
    through ``make_train_step``; the flash launch count zeroed just before and
    read just after. Gates: finite losses, the last below the first, and two
    flash launches a layer a step on the card (the forward and the group's
    recompute under remat), no other route."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.models import model as lm

    t = cfg["lm_train"]
    arch = get_arch(t["arch"])
    mcfg = reduced(arch) if t["reduced"] else arch
    B, S, steps = t["batch"], t["seq"], t["steps"]
    t0 = time.perf_counter()
    model, opt, step_fn = train_parts(mcfg, t["lr"], steps, seed, device)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params = lm.param_count(model)
    data = batch_iterator(mcfg, B, S, 0, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    flash = _flash()
    flash.launches = 0
    losses, times, metrics = train_steps(step_fn, model, opt, data, steps, device)
    launches = flash.launches
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"dense training: losses {losses}")
    per_step = 2 * mcfg.num_layers if mcfg.remat == "full" else mcfg.num_layers
    if device.type == "cuda" and launches != per_step * steps:
        raise AssertionError(f"flash_attention_bhsd ran {launches} times in {steps} steps of "
                             f"{mcfg.num_layers} layers (remat {mcfg.remat})")
    step_s = float(np.median(times[2:]))
    flops = 6.0 * n_params * B * S
    bound_s = flops / PEAK_F32_FLOPS
    split = None
    if device.type == "cuda":
        split = train_step_split(lambda: step_fn(model, opt, next(data)), mcfg.vocab_size)
        if "device_busy_ms" in split:  # the profiler stretches the traced step's wall
            split["idle_share_of_an_untraced_step"] = 1 - split["device_busy_ms"] / (step_s * 1e3)
    del model, opt
    return dict(arch=mcfg.name, layers=mcfg.num_layers, d_model=mcfg.d_model,
                vocab=mcfg.vocab_size, remat=mcfg.remat, params=n_params, batch=B, seq=S,
                steps=steps, lr=t["lr"], schedule="warmup_cosine(warmup=2, total=20)",
                init_s=init_s, step_s_median_3_to_20=step_s, step_s=times,
                tokens_per_s=B * S / step_s, peak_device_bytes=peak,
                loss_first=losses[0], loss_last=losses[-1], losses=losses,
                grad_norm=[m["grad_norm"] for m in metrics],
                flash_launches=launches, flash_launches_per_step=launches / steps,
                f32_bound=dict(flops_per_step=flops, what="6 N T at 67 TFLOP/s f32, before remat",
                               seconds=bound_s, step_share=bound_s / step_s),
                profiled_step=split)


def attention_gradients(cfg, device) -> list:
    """(b) The Function's (out, dq, dk, dv) against autograd through
    ``flash_attention_ref`` on the same inputs: out within FLASH_TOL (f32),
    each gradient within ATTN_GRAD_RTOL * max|g|. On the card also the
    backward's time (``attention_backward``), the plain version's backward,
    ``scaled_dot_product_attention``'s backward and the bound (5 products of
    2 Dh FLOPs a causal pair and head; q, k, v, dO read and dq, dk, dv
    written once)."""
    from repro_torch.kernels import ref

    flash = _flash()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for B, S, H, Hkv, Dh in cfg["lm_train"]["grad_shapes"]:
        g = torch.Generator(device=device).manual_seed(31)
        q = torch.randn((B, S, H, Dh), generator=g, device=device)
        k, v = (torch.randn((B, S, Hkv, Dh), generator=g, device=device) for _ in range(2))
        dout = torch.randn((B, S, H, Dh), generator=g, device=device)
        mine = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = flash.flash_attention(*mine)
        got = torch.autograd.grad(out, mine, dout)
        plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out_ref = ref.flash_attention_ref(*plain)
        want = torch.autograd.grad(out_ref, plain, dout, retain_graph=True)
        rtol, atol = FLASH_TOL[torch.float32]
        label = f"attention gradients {(B, S, H, Hkv, Dh)}"
        row = dict(shape=dict(B=B, S=S, H=H, Hkv=Hkv, Dh=Dh),
                   out_max_abs_err=check_close(label + " out", out.detach(), out_ref.detach(),
                                               rtol, atol),
                   out_tolerance=dict(rtol=rtol, atol=atol), grads={})
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            if not (bool(torch.isfinite(a).all()) and err <= ATTN_GRAD_RTOL * scale):
                raise AssertionError(f"{label} {name}: max |d| {err} against "
                                     f"{ATTN_GRAD_RTOL} * {scale}")
            row["grads"][name] = dict(max_abs_err=err, max_abs=scale, rel=err / scale,
                                      limit=ATTN_GRAD_RTOL * scale)
        if device.type == "cuda":
            pairs = S * (S + 1) / 2
            flops = 10.0 * Dh * pairs * B * H
            b_ms, b_by = bound(flops, 4.0 * (3 * B * S * H * Dh + 4 * B * S * Hkv * Dh))
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
            kw = dict(enable_gqa=True) if Hkv != H else {}
            o = sdpa(qt, kt, vt, is_causal=True, **kw)
            dot = dout.transpose(1, 2).contiguous()
            row.update(
                backward_ms=cuda_ms(lambda: flash.attention_backward(q, k, v, dout), 5),
                forward_ms=cuda_ms(lambda: flash.flash_attention_bhsd(q, k, v), 5),
                plain_backward_ms=cuda_ms(lambda: torch.autograd.grad(
                    out_ref, plain, dout, retain_graph=True), 3, warmup=1),
                sdpa_backward_ms=cuda_ms(lambda: torch.autograd.grad(
                    o, (qt, kt, vt), dot, retain_graph=True), 5),
                sdpa_backend=sdpa_backend(qt, kt, vt, **kw), backward_bound_ms=b_ms,
                backward_bound_by=b_by, backward_flops=flops,
                backward_chunk=flash.BWD_CHUNK)
            row["backward_roofline_share"] = b_ms / row["backward_ms"]
            del qt, kt, vt, o, dot
        rows.append(row)
        del q, k, v, dout, mine, out, got, plain, out_ref, want
    return rows


def kernel_vs_plain_step(cfg, device, seed) -> dict:
    """(c) One full-width step of qwen1.5-0.5b at ``step_layers`` layers: the
    loss and every parameter's gradient with attention through the Function
    (the kernel) against attention through the plain version under autograd.
    Gates: loss within STEP_LOSS_RTOL, each leaf within STEP_GRAD_RTOL *
    max|g|, and every layer's wq, wk, wv, bq, bk and bv with a finite,
    non-zero gradient on the kernel route (the launch records no autograd
    history of its own)."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY

    t = cfg["lm_train"]
    arch = get_arch(t["arch"])
    mcfg = dataclasses.replace(reduced(arch) if t["reduced"] else arch,
                               num_layers=t["step_layers"])
    model = lm.init(torch.Generator(device=device).manual_seed(seed), mcfg, TEST_POLICY, device)
    batch = next(batch_iterator(mcfg, t["batch"], t["seq"], 0, device))
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    flash = _flash()
    flash.launches = 0
    loss_k, _ = lm.forward_train(model, mcfg, TEST_POLICY, batch)
    g_k = dict(zip(named, torch.autograd.grad(loss_k, list(named.values()))))
    kernel_launches = flash.launches
    with plain_attention():
        loss_p, _ = lm.forward_train(model, mcfg, TEST_POLICY, batch)
        g_p = dict(zip(named, torch.autograd.grad(loss_p, list(named.values()))))
    plain_launches = flash.launches - kernel_launches
    loss_k, loss_p = float(loss_k.detach()), float(loss_p.detach())
    if device.type == "cuda" and (kernel_launches < mcfg.num_layers or plain_launches):
        raise AssertionError(f"kernel route {kernel_launches} launches, plain {plain_launches}")
    if not abs(loss_k - loss_p) <= STEP_LOSS_RTOL * abs(loss_p):
        raise AssertionError(f"kernel vs plain loss {loss_k} vs {loss_p}")
    worst, zero = {}, []
    for name, a in g_k.items():
        b = g_p[name]
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        worst[name] = err / scale if scale else err
        if not (bool(torch.isfinite(a).all()) and err <= STEP_GRAD_RTOL * scale):
            raise AssertionError(f"kernel vs plain gradient of {name}: {err} against "
                                 f"{STEP_GRAD_RTOL} * {scale}")
        if name.split(".")[-1] in ("wq", "wk", "wv", "bq", "bk", "bv") and not bool((a != 0).any()):
            zero.append(name)
    projections = [n for n in g_k if n.split(".")[-1] in ("wq", "wk", "wv", "bq", "bk", "bv")]
    if zero or len(projections) != 6 * mcfg.num_layers:
        raise AssertionError(f"attention projections without a gradient: {zero}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    del model, g_k, g_p
    return dict(layers=mcfg.num_layers, d_model=mcfg.d_model, batch=t["batch"], seq=t["seq"],
                loss_kernel=loss_k, loss_plain=loss_p,
                loss_rel_diff=abs(loss_k - loss_p) / abs(loss_p), loss_rtol=STEP_LOSS_RTOL,
                grad_rtol=STEP_GRAD_RTOL, worst_grad_rel_diff=dict(top),
                projections_with_nonzero_grad=len(projections),
                kernel_launches=kernel_launches, plain_launches=plain_launches)


def crash_and_resume_training(cfg, device, seed) -> dict:
    """(d) qwen1.5-0.5b at full width, ``step_layers`` layers: 20 steps through
    ``TrainLoop`` with a checkpoint every 10, and the same run crashed by
    ``fault_hook`` at step 12 and restarted with a fresh model. Under
    ``torch.use_deterministic_algorithms`` the restarted run's params and
    moments after step 20 are the uninterrupted run's bit for bit. The
    saves' seconds and bytes are printed; the directory is removed."""
    import dataclasses
    import shutil
    import tempfile
    import warnings

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.distributed import checkpoint as ckpt_lib
    from repro_torch.train.loop import LoopConfig, TrainLoop

    t = cfg["lm_train"]
    arch = get_arch(t["arch"])
    mcfg = dataclasses.replace(reduced(arch) if t["reduced"] else arch,
                               num_layers=t["step_layers"])
    steps, every, crash_at = t["resume_steps"], t["resume_every"], t["crash_at"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    saves, snapshots = [], []
    save, async_save = ckpt_lib.save, ckpt_lib.AsyncCheckpointer.save

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        out = save(*a, **kw)
        saves.append(dict(seconds=time.perf_counter() - t0, bytes=dir_bytes(out), step=a[1]))
        return out

    def timed_snapshot(self, *a, **kw):
        t0 = time.perf_counter()
        async_save(self, *a, **kw)
        snapshots.append(time.perf_counter() - t0)

    class Crash(RuntimeError):
        pass

    def crash(step):
        if step == crash_at and not (root / "crashed").exists():
            (root / "crashed").write_text("x")
            raise Crash()

    def run(path, fault_hook=None):
        model, opt, step_fn = train_parts(mcfg, t["lr"], steps, seed, device)
        loop = TrainLoop(step_fn, lambda s: batch_iterator(mcfg, t["batch"], t["seq"], s, device),
                         path, LoopConfig(total_steps=steps, checkpoint_every=every, log_every=1),
                         fault_hook=fault_hook)
        return loop.run(model, opt)

    # One CUDA stream and the same shapes in both runs keep cuBLAS's bits
    # fixed; the variable only satisfies PyTorch's check for the mode.
    workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    flash = _flash()
    flash.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with patched(ckpt_lib, "save", timed_save), \
                    patched(ckpt_lib.AsyncCheckpointer, "save", timed_snapshot):
                p_ref, o_ref, _ = run(root / "a")
                crashed = False
                try:
                    run(root / "b", crash)
                except Crash:
                    crashed = True
                p, o, history = run(root / "b", crash)
        finally:
            torch.use_deterministic_algorithms(was)
            if workspace is None:
                del os.environ["CUBLAS_WORKSPACE_CONFIG"]
    launches = flash.launches
    not_deterministic = sorted({str(w.message)[:160] for w in caught
                                if "deterministic" in str(w.message)})
    ref_params = dict(p_ref.named_parameters())
    differ = [n for n, x in p.named_parameters() if not torch.equal(x, ref_params[n])]
    differ += [f"mu.{n}" for n in o.mu if not torch.equal(o.mu[n], o_ref.mu[n])]
    differ += [f"nu.{n}" for n in o.nu if not torch.equal(o.nu[n], o_ref.nu[n])]
    shutil.rmtree(root)
    if not crashed or differ or int(o.step) != steps or [r["step"] for r in history] != list(
            range(every, steps)):
        raise AssertionError(f"crash and resume: crashed={crashed}, differ={differ[:5]}, "
                             f"step={int(o.step)}, resumed steps {[r['step'] for r in history]}")
    del p_ref, o_ref, p, o
    return dict(layers=mcfg.num_layers, steps=steps, checkpoint_every=every, crash_at=crash_at,
                bitwise_equal=True, deterministic_mode=True,
                ops_without_a_deterministic_version=not_deterministic,
                saves=saves, async_snapshot_s=snapshots,
                save_bytes=max(s["bytes"] for s in saves), flash_launches=launches,
                temp_dir_removed=not root.exists())


def route_spy(counts):
    """``moe.route`` that adds each call's dropped and routed (token, choice)
    pairs to ``counts`` (device tensors: no sync), inside the block."""
    from repro_torch.models import moe

    route = moe.route

    def spy(*a, **kw):
        r = route(*a, **kw)
        counts["dropped"] = counts["dropped"] + (~r.keep).sum()
        counts["pairs"] += r.keep.numel()
        return r

    return patched(moe, "route", spy)


def moe_training(cfg, device, seed) -> dict:
    """(e) qwen2-moe-a2.7b at full width (d_model 2,048, 16 x 128 heads, 60
    routed experts top-4 of d_ff 1,408, 4 shared, untied vocab 151,936),
    ``moe_layers`` of its 24 layers: a 2 x 2,048 prefill and 16 greedy decode
    steps (``serve.generate``), then ``moe_steps`` train steps from
    ``batch_iterator``. Decode is held against the full forward at 2 x 128
    tokens: a prefill of 2 x 112 and 16 teacher-forced decode steps, each
    step's logits against a full prefill over the same tokens. (The MoE
    groups take min(256, B S) tokens and must divide B S; at 2 x 2,048 a
    full forward over the prompt and the decoded tokens would not.) A
    decode step routes its 2 tokens in one group of capacity 1, the full
    forward up to 256 in one group of capacity 21, where the last tokens'
    later choices overflow: the two drop different (token, choice) pairs by
    construction, and at 60 experts top-4 the gap outgrows the reference's
    bound, in the reference too (6.4e-2 at d_model 256, both packages
    alike). So the gap is printed at the arch's capacity factor and gated
    at the reference's bound with the factor raised to E / k for both
    sides, where nothing is dropped. Gates: finite, tokens in range, that
    bound, aux > 0, finite losses, one flash launch a layer in the
    prefill."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.tokens import batch_iterator, synthetic_batch
    from repro_torch.launch import serve
    from repro_torch.models import model as lm
    from repro_torch.models import moe
    from repro_torch.models.common import TEST_POLICY

    t = cfg["lm_train"]
    arch = get_arch(t["moe_arch"])
    mcfg = dataclasses.replace(reduced(arch) if t["reduced"] else arch,
                               num_layers=t["moe_layers"])
    B, S, gen = t["moe_batch"], t["moe_seq"], t["moe_gen"]
    model, opt, step_fn = train_parts(mcfg, t["lr"], t["moe_steps"], seed, device)
    n_params = lm.param_count(model)
    prompt = torch.as_tensor(synthetic_batch(mcfg, 0, B, S)["tokens"], device=device)
    flash = _flash()
    flash.launches = 0
    res = serve.generate(model, mcfg, TEST_POLICY, {"tokens": prompt}, gen)
    serve_launches = flash.launches
    if not bool(torch.isfinite(res.logits).all()) or int(res.tokens.min()) < 0 \
            or int(res.tokens.max()) >= mcfg.vocab_size:
        raise AssertionError("MoE generate: non-finite logits or tokens out of range")
    if device.type == "cuda" and serve_launches != mcfg.num_layers:
        raise AssertionError(f"MoE prefill launched flash_attention_bhsd {serve_launches} times")

    short = prompt[:, :128]
    P = short.shape[1] - gen

    def forced_gap() -> float:
        forced = teacher_forced(model, mcfg, TEST_POLICY, {"tokens": short[:, :P]}, short[:, P:])
        with torch.inference_mode():
            return max(float((forced[i + 1] - lm.forward_prefill(
                model, mcfg, TEST_POLICY, {"tokens": short[:, :P + i + 1]})[0]).abs().max())
                for i in range(gen))

    raw_gap = forced_gap()
    with patched(moe, "CAPACITY_FACTOR", mcfg.moe.num_experts / mcfg.moe.top_k):
        decode_err = forced_gap()
    if not decode_err < MOE_DECODE_TOL:
        raise AssertionError(f"MoE decode vs full forward, no drops: {decode_err}")

    counts = dict(dropped=torch.zeros((), dtype=torch.int64, device=device), pairs=0)
    data = batch_iterator(mcfg, B, S, 0, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    flash.launches = 0
    with route_spy(counts):
        losses, times, metrics = train_steps(step_fn, model, opt, data, t["moe_steps"], device)
    train_launches = flash.launches
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    aux = [m["aux"] for m in metrics]
    if not all(np.isfinite(losses)) or not all(a > 0 and np.isfinite(a) for a in aux):
        raise AssertionError(f"MoE training: losses {losses}, aux {aux}")
    del model, opt
    return dict(arch=mcfg.name, layers=mcfg.num_layers, d_model=mcfg.d_model,
                experts=mcfg.moe.num_experts, top_k=mcfg.moe.top_k, shared=mcfg.moe.num_shared,
                vocab=mcfg.vocab_size, params=n_params, batch=B, seq=S, gen=gen,
                prefill_s=res.prefill_s, decode_ms_per_step=res.decode_s / gen * 1e3,
                decode_vs_full=dict(no_drops_max_abs_diff=decode_err, limit=MOE_DECODE_TOL,
                                    capacity_factor_no_drops=mcfg.moe.num_experts / mcfg.moe.top_k,
                                    max_abs_diff_at_capacity_factor=raw_gap,
                                    capacity_factor=moe.CAPACITY_FACTOR,
                                    tokens=[B, short.shape[1]], prefill=P),
                train_steps=t["moe_steps"], step_s=times,
                step_s_median=float(np.median(times[1:])), losses=losses, aux=aux,
                dropped_share=float(counts["dropped"]) / max(counts["pairs"], 1),
                routed_pairs=counts["pairs"], peak_device_bytes=peak,
                flash_launches=dict(prefill=serve_launches, train=train_launches))


def phase_lm_train(cfg, device, seed) -> dict:
    """The LM's training path: (a) dense training at full width and depth,
    (b) the attention gradients at full shapes, (c) one full-width step,
    kernel route against plain route, (d) crash and resume bit for bit, (e)
    the MoE arch at full width. TF32 stays off."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: training must be f32 as in the reference")
    info = dict(phase="lm_train")
    for key, part in (("a_dense", dense_training), ("b_attention_gradients", attention_gradients),
                      ("c_kernel_vs_plain_step", kernel_vs_plain_step),
                      ("d_crash_and_resume", crash_and_resume_training),
                      ("e_moe", moe_training)):
        t0 = time.perf_counter()
        try:
            info[key] = part(cfg, device, seed) if part is not attention_gradients \
                else part(cfg, device)
        except BaseException:
            print(json.dumps(info), file=sys.stderr, flush=True)  # the parts that passed
            raise
        if device.type == "cuda":
            torch.cuda.empty_cache()
        info[f"{key}_s"] = time.perf_counter() - t0
    info["flash_launches"] = (info["a_dense"]["flash_launches"]
                              + info["d_crash_and_resume"]["flash_launches"]
                              + info["e_moe"]["flash_launches"]["prefill"]
                              + info["e_moe"]["flash_launches"]["train"])
    return info


# ------------------------------------------------------ LM: SSM and frontends

#: The card's logits against the port's CPU path from the same parameters,
#: on a reduced model: the reference's flash-attention tolerance (FLASH_TOL
#: f32, rtol 2e-4 and atol 2e-5), the rtol taken of max |logits|. Both sides
#: are f32; they differ in cuBLAS's and the CPU's sums and the attention
#: kernel's against the plain softmax.
SSM_CARD_RTOL, SSM_CARD_ATOL = 2e-4, 2e-5
#: The reference's decode-vs-full bars on a reduced model
#: (tests/test_models_smoke.py): 2e-3, 5e-2 with MoE.
DECODE_TOL, DECODE_TOL_MOE = 2e-3, 5e-2


def f32_states():
    """Prefill keeps the SSM layers' bf16 states (Mamba's conv window,
    RWKV6's x_tmix and x_cmix) in f32 inside the block."""
    from repro_torch.models import mamba, rwkv6

    stack = contextlib.ExitStack()
    for mod in (mamba, rwkv6):
        stack.enter_context(patched(mod, "CACHE_DTYPE", torch.float32))
    return stack


def lm_inputs(mcfg, B, S, device) -> dict:
    """``synthetic_batch`` of S model positions on the card, without its mask:
    tokens, codes (B, K, S), or P patch embeddings and S - P tokens."""
    from repro_torch.data.tokens import synthetic_batch

    return {k: torch.as_tensor(v, device=device)
            for k, v in synthetic_batch(mcfg, 0, B, S).items() if k != "loss_mask"}


def reduced_checks(arch, device, seed, check) -> dict:
    """The arch's reduced model (f32) drawn on the card and copied to the CPU:
    a prefill and ``steps`` teacher-forced decode steps on both, within
    SSM_CARD_RTOL * max|logits| + SSM_CARD_ATOL; and decode against the full
    forward on the card at the reference's bar."""
    import copy

    from repro_torch.configs import reduced
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY

    small = reduced(arch)
    model = lm.init(torch.Generator(device=device).manual_seed(seed), small, TEST_POLICY, device)
    cpu_model = copy.deepcopy(model).to("cpu")
    batch = lm_inputs(small, check["batch"], check["prompt"], device)
    key, n = _step_key(small), check["steps"]
    prompt = dict(batch, **{key: batch[key][..., :-n]})
    card = teacher_forced(model, small, TEST_POLICY, prompt, batch[key][..., -n:]).cpu()
    host = teacher_forced(cpu_model, small, TEST_POLICY,
                          {k: v.cpu() for k, v in prompt.items()}, batch[key][..., -n:].cpu())
    scale = float(host.abs().max())
    diff = float((card - host).abs().max())
    limit = SSM_CARD_RTOL * scale + SSM_CARD_ATOL
    if not diff <= limit:
        raise AssertionError(f"{small.name}: card vs CPU logits differ by {diff} (limit {limit})")
    with torch.inference_mode():
        full, _ = lm.forward_prefill(model, small, TEST_POLICY, batch)
    dvf = decode_vs_full(model, small, TEST_POLICY, batch, full)
    bar = DECODE_TOL_MOE if small.moe is not None else DECODE_TOL
    if not dvf < bar:
        raise AssertionError(f"{small.name}: decode vs full forward {dvf} (bar {bar})")
    return dict(arch=small.name, tokens=[check["batch"], check["prompt"]],
                card_vs_cpu=dict(max_abs_diff=diff, limit=limit, logits_abs_max=scale,
                                 steps=check["steps"]),
                decode_vs_full=dict(max_abs_diff=dvf, limit=bar))


def scan_ms(part, model, mcfg, batch, device) -> dict | None:
    """Device ms of the selective scan / WKV recurrence of one layer at this
    part's full shape (plain ``torch`` loops, the lax.scan's counterpart),
    inputs drawn at the shapes the layer gives it, and its bound: the inputs
    read and the outputs written once, at the card's memory rate."""
    from repro_torch.models import mamba, rwkv6

    if part not in ("rwkv", "jamba"):
        return None
    B, S = batch["tokens"].shape
    g = torch.Generator(device=device).manual_seed(0)
    if part == "rwkv":
        Hp, hs = mcfg.phys_heads, mcfg.rwkv_head_size
        r, k, v = (torch.randn((B, S, Hp, hs), generator=g, device=device) for _ in range(3))
        w = torch.rand((B, S, Hp, hs), generator=g, device=device)
        u = model.groups[0].layer0.mixer.u
        run = lambda: rwkv6._wkv_scan(r, k, v, w, u)  # noqa: E731
        nbytes = 5 * r.numel() * 4 + B * Hp * hs * hs * 4
        what = "wkv6 recurrence"
    else:
        di, N = mcfg.ssm_d_inner, mcfg.ssm_state
        xc, dt = (torch.rand((B, S, di), generator=g, device=device) * 0.1 for _ in range(2))
        Bm, Cm = (torch.randn((B, S, N), generator=g, device=device) for _ in range(2))
        A = -torch.exp(model.groups[0].layer0.mixer.A_log)
        run = lambda: mamba._scan(mcfg, xc, dt, Bm, Cm, A)  # noqa: E731
        nbytes = (3 * xc.numel() + 2 * Bm.numel()) * 4 + B * di * N * 4
        what = "selective scan"
    with torch.inference_mode():
        ms = cuda_ms(run, iters=2, warmup=1)
    return dict(what=what, shape=[B, S], ms=ms, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                bound_by="bytes", per_token_us=ms * 1e3 / S)


def cut_arch(arch_name, spec, reduced_run, **over):
    """A part's config: the arch (reduced in the rehearsal), its depth,
    experts and padded heads cut as ``spec`` sets them, and ``over``."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced

    mcfg = reduced(get_arch(arch_name)) if reduced_run else get_arch(arch_name)
    cuts = dict(over)
    if spec.get("layers") and "num_layers" not in cuts:
        cuts["num_layers"] = spec["layers"]
    if spec.get("experts") and mcfg.moe is not None:
        cuts["moe"] = dataclasses.replace(mcfg.moe, num_experts=min(spec["experts"],
                                                                    mcfg.moe.num_experts))
    if spec.get("padded_heads"):
        cuts["padded_heads"] = spec["padded_heads"]
    return dataclasses.replace(mcfg, **cuts)


def ssm_part(part, spec, cfg, device, seed) -> dict:
    """One arch at its published widths (depth and experts as ``spec`` cuts
    them) from a seeded random init: ``serve.generate`` over ``spec``'s
    prompt and greedy decode steps, the flash launch count zeroed just
    before and read just after (one a prefill per attention layer, none in
    decode, where attention is ``torch`` ops); then the reduced model's
    gates (``reduced_checks``)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY, Policy

    t = cfg["lm_ssm"]
    arch = get_arch(spec["arch"])
    mcfg = cut_arch(spec["arch"], spec, t["reduced"])
    policy = (Policy(torch.bfloat16, torch.bfloat16) if spec.get("dtype") == "bfloat16"
              else TEST_POLICY)
    B, S, gen = spec["batch"], spec["prompt"], spec["gen"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = lm.init(torch.Generator(device=device).manual_seed(seed), mcfg, policy, device)
    batch = lm_inputs(mcfg, B, S, device)
    sync(device)
    init_s = time.perf_counter() - t0
    flash = _flash()
    flash.launches = 0
    res = serve.generate(model, mcfg, policy, batch, gen)
    launches = flash.launches
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    attn_layers = sum(s.mixer == "attn" for s in mcfg.layer_pattern()) * mcfg.num_groups
    if not bool(torch.isfinite(res.logits).all()):
        raise AssertionError(f"{mcfg.name}: non-finite logits")
    if int(res.tokens.min()) < 0 or int(res.tokens.max()) >= mcfg.vocab_size:
        raise AssertionError(f"{mcfg.name}: generated tokens out of range")
    if device.type == "cuda" and launches != attn_layers:
        raise AssertionError(f"{mcfg.name}: flash_attention_bhsd ran {launches} times for "
                             f"{attn_layers} attention layers")
    out = dict(arch=mcfg.name, layers=mcfg.num_layers, d_model=mcfg.d_model,
               pattern=[f"{s.mixer}+{s.ffn}" for s in mcfg.layer_pattern()],
               experts=None if mcfg.moe is None else [mcfg.moe.num_experts, mcfg.moe.top_k],
               cuts=dict(layers=[arch.num_layers, mcfg.num_layers],
                         experts=None if arch.moe is None else [arch.moe.num_experts,
                                                                mcfg.moe.num_experts]),
               dtype=str(policy.param_dtype).replace("torch.", ""),
               params=lm.param_count(model),
               param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
               batch=B, prompt=S, gen=gen, init_s=init_s, prefill_s=res.prefill_s,
               decode_ms_per_step=res.decode_s / gen * 1e3,
               decode_tokens_per_s=B * gen / res.decode_s, peak_device_bytes=peak,
               flash_launches=launches, attention_layers=attn_layers,
               first_tokens=res.tokens[..., :4].tolist()[:2])
    if part == "rwkv":  # decode against the full prefill, as phase lm_serve gates it
        dvp = dict(bf16_states=decode_vs_full(model, mcfg, policy, batch, res.logits[0]))
        with f32_states():
            dvp["f32_states"] = decode_vs_full(model, mcfg, policy, batch, res.logits[0])
        limits = dict(bf16_states=2e-2, f32_states=2e-3)
        if any(dvp[k] > lim for k, lim in limits.items()):
            raise AssertionError(f"{mcfg.name}: decode vs prefill {dvp} (limits {limits})")
        out["decode_vs_prefill"] = dict(max_abs_diff=dvp, limit=limits)
    if device.type == "cuda":
        out["scan"] = scan_ms(part, model, mcfg, batch, device)
    del model, res
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["reduced"] = reduced_checks(arch, device, seed, t["check"])
    return out


def phase_lm_ssm(cfg, device, seed) -> dict:
    """The SSM mixers and the frontends: (a) rwkv6-3b at full width and
    depth, (b) one jamba-1.5-large-398b group at full width (bf16, its 16
    experts cut to 4), (c) musicgen-large at full width and depth, (d)
    llava-next-34b at full width on 2 layers. TF32 stays off."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: the projections must be f32 as in the reference")
    info = dict(phase="lm_ssm")
    for key, part in (("a_rwkv6", "rwkv"), ("b_jamba", "jamba"), ("c_musicgen", "musicgen"),
                      ("d_llava", "llava")):
        t0 = time.perf_counter()
        try:
            info[key] = ssm_part(part, cfg["lm_ssm"][part], cfg, device, seed)
        except BaseException:
            print(json.dumps(info), file=sys.stderr, flush=True)  # the parts that passed
            raise
        info[f"{key}_s"] = time.perf_counter() - t0
    info["flash_launches"] = sum(info[k]["flash_launches"]
                                 for k in ("a_rwkv6", "b_jamba", "c_musicgen", "d_llava"))
    return info


# ------------------------------------------------------------ SSM training at full width


@contextlib.contextmanager
def step_parts(device, record: list):
    """Inside the block each ``make_train_step`` step's backward
    (``train.step._grads``) and optimizer (``adamw.update``) run between two
    device syncs, their seconds appended to ``record`` as (part, s); the
    forward is the rest of the step."""
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod

    def timed(part, fn):
        def wrapped(*a, **kw):
            sync(device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync(device)
            record.append((part, time.perf_counter() - t0))
            return out

        return wrapped

    with patched(step_mod, "_grads", timed("backward", step_mod._grads)), \
            patched(adamw, "update", timed("optimizer", adamw.update)):
        yield


@contextlib.contextmanager
def grad_spy(out: dict):
    """Inside the block each train step's gradients copied into ``out`` on
    the host, by parameter name."""
    from repro_torch.train import step as step_mod

    grads = step_mod._grads

    def spy(params, loss):
        g = grads(params, loss)
        out.update({n: t.detach().to("cpu", torch.float32) for n, t in g.items()})
        return g

    with patched(step_mod, "_grads", spy):
        yield


def ssm_training(spec, mcfg, device, seed) -> dict:
    """(a) / (b): ``steps`` AdamW steps of ``mcfg`` from a seeded init (f32
    params and math, the arch's moments) on ``batch`` x ``seq`` tokens of
    ``batch_iterator``, lr ``spec["lr"]`` under warmup_cosine(warmup=0),
    each step split into forward, backward and optimizer (``step_parts``).
    Gates: every loss and gradient norm finite, the last loss below the
    first, every parameter finite after the steps. Reports the peak device
    bytes beside the prediction and beside the dry-run's placement of the
    same cell on ``meta`` (parameters, their gradients, the AdamW state)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY
    from repro_torch.optim import adamw

    arch = get_arch(spec["arch"])
    B, S, steps = spec["batch"], spec["seq"], spec["steps"]
    fresh_peak(device)
    t0 = time.perf_counter()
    model, opt, step_fn = train_parts(mcfg, spec["lr"], steps, seed, device, warmup=0)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params = lm.param_count(model)
    data = batch_iterator(mcfg, B, S, 0, device)
    parts: list = []
    with step_parts(device, parts):
        losses, times, metrics = train_steps(step_fn, model, opt, data, steps, device)
    peak = peak_bytes(device)
    grad_norms = [m["grad_norm"] for m in metrics]
    params_finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    del model, opt, data
    fresh_peak(device)
    back = [s for part, s in parts if part == "backward"]
    optim = [s for part, s in parts if part == "optimizer"]
    split = [dict(step_s=t, forward_s=t - b - o, backward_s=b, optimizer_s=o)
             for t, b, o in zip(times, back, optim)]
    step_s = float(np.median(times[1:] if steps > 1 else times))
    opt_cfg = adamw.AdamWConfig(lr=spec["lr"], moments_dtype=mcfg.moments_dtype)
    param_b, opt_b = dryrun.state_bytes(mcfg, TEST_POLICY, opt_cfg,
                                        make_mesh((1, 1), ("data", "model"), devices=["meta"]))
    cuts = dict(layers=[arch.num_layers, mcfg.num_layers],
                experts=None if arch.moe is None else [arch.moe.num_experts,
                                                       mcfg.moe.num_experts])
    out = dict(arch=mcfg.name, layers=mcfg.num_layers, d_model=mcfg.d_model,
               pattern=[f"{s.mixer}+{s.ffn}" for s in mcfg.layer_pattern()],
               d_inner=mcfg.ssm_d_inner if any(s.mixer == "mamba" for s in
                                               mcfg.layer_pattern()) else None, d_ff=mcfg.d_ff,
               vocab=mcfg.vocab_size, heads=[mcfg.num_heads, mcfg.phys_heads],
               experts=None if mcfg.moe is None else [mcfg.moe.num_experts, mcfg.moe.top_k,
                                                      mcfg.moe.d_ff_expert],
               cuts=cuts, reduced=[k for k, v in cuts.items() if v and v[0] != v[1]],
               params=n_params, param_dtype="float32", moments_dtype=mcfg.moments_dtype,
               remat=mcfg.remat, batch=B, seq=S, steps=steps, lr=spec["lr"],
               schedule=f"warmup_cosine(warmup=0, total={steps})", init_s=init_s,
               step_s=times, step_s_median_after_first=step_s, split_s=split,
               tokens_per_s=B * S / step_s, losses=losses, loss_first=losses[0],
               loss_last=losses[-1], grad_norm=grad_norms, peak_device_bytes=peak,
               predicted=dict(peak_gb=spec["peak_gb"], step_s=spec["step_s"]),
               dryrun_placement=dict(param_bytes=param_b, grad_bytes=param_b,
                                     opt_state_bytes=opt_b, total_bytes=2 * param_b + opt_b,
                                     mesh="(1, 1) of meta", what="dryrun.state_bytes"))
    if not (all(np.isfinite(losses)) and all(np.isfinite(grad_norms)) and params_finite):
        raise AssertionError(f"{mcfg.name}: non-finite loss, gradient norm or parameter "
                             f"(parameters finite: {params_finite}): {json.dumps(out)}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{mcfg.name}: the loss did not fall: {json.dumps(out)}")
    return out


def reduced_step_card_vs_cpu(arch_name, check, device, seed) -> dict:
    """(c): one ``make_train_step`` step of the arch's reduced config (its
    moments dtype) from one seeded init, on the card and on a CPU copy, over
    one batch: the loss within STEP_LOSS_RTOL and each gradient leaf within
    STEP_GRAD_RTOL * its max |g| on the CPU."""
    import copy

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.optim import adamw

    small = reduced(get_arch(arch_name))
    model, _, step_fn = train_parts(small, check["lr"], 1, seed, device)
    cpu_model = copy.deepcopy(model).to("cpu")
    opt_cfg = adamw.AdamWConfig(lr=check["lr"], moments_dtype=small.moments_dtype)
    host = {k: torch.from_numpy(v)
            for k, v in synthetic_batch(small, 0, check["batch"], check["seq"]).items()}
    runs = {}
    for where, mdl in (("card", model), ("cpu", cpu_model)):
        dev = next(mdl.parameters()).device
        grads: dict = {}
        with grad_spy(grads):
            _, _, m = step_fn(mdl, adamw.init(mdl, opt_cfg), {k: v.to(dev)
                                                              for k, v in host.items()})
        runs[where] = (float(m["loss"]), grads)
    (loss, grads), (want_loss, want) = runs["card"], runs["cpu"]
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    worst = max((float((grads[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30), n)
                for n, g in want.items())
    if not loss_rel <= STEP_LOSS_RTOL or not worst[0] <= STEP_GRAD_RTOL:
        raise AssertionError(f"{small.name}: card vs CPU loss rel {loss_rel} (bar "
                             f"{STEP_LOSS_RTOL}), worst gradient {worst} (bar {STEP_GRAD_RTOL})")
    return dict(arch=small.name, tokens=[check["batch"], check["seq"]],
                moments_dtype=small.moments_dtype, loss_card=loss, loss_cpu=want_loss,
                loss_rel_diff=loss_rel, grad_leaves=len(want), worst_grad_rel=worst[0],
                worst_grad_leaf=worst[1],
                limits=dict(loss_rtol=STEP_LOSS_RTOL, grad_rtol_of_max=STEP_GRAD_RTOL))


def phase_lm_ssm_train(cfg, device, seed) -> dict:
    """Mamba and RWKV6 training at full width on the one card: (a) rwkv6-3b
    at d 2,560 (40 wkv heads padded to 48) on the config's depth (16 of its
    32 layers), f32 parameters and moments; (b) jamba-1.5-large-398b at full
    width (d_model 8,192, d_inner 16,384) on 2 layers, a Mamba + dense and a
    Mamba + MoE, its 16 experts cut to 2 (top-2 kept), its bf16 moments; both under
    ``remat="full"`` (one layer group's per-token autograd graph at a time);
    (c) one step of each arch's reduced config, card against CPU. TF32
    stays off."""
    from repro_torch.configs.base import LayerSpec

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: the projections must be f32 as in the reference")
    c = cfg["lm_ssm_train"]
    rwkv = cut_arch("rwkv6-3b", c["rwkv"], c["reduced"])
    jamba = cut_arch("jamba-1.5-large-398b", c["jamba"], c["reduced"],
                     pattern=(LayerSpec("mamba", "dense"), LayerSpec("mamba", "moe")))
    flash = _flash()
    flash.launches = 0
    info = dict(phase="lm_ssm_train")
    parts = (("a_rwkv6", lambda: ssm_training(c["rwkv"], rwkv, device, seed)),
             ("b_jamba", lambda: ssm_training(c["jamba"], jamba, device, seed)),
             ("c_card_vs_cpu", lambda: {
                 arch: reduced_step_card_vs_cpu(arch, c["check"], device, seed)
                 for arch in ("rwkv6-3b", "jamba-1.5-large-398b")}))
    for key, part in parts:
        t0 = time.perf_counter()
        try:
            info[key] = part()
        except BaseException:
            print(json.dumps(info), file=sys.stderr, flush=True)  # the parts that passed
            raise
        info[f"{key}_s"] = time.perf_counter() - t0
    info["flash_launches"] = flash.launches  # (c)'s reduced jamba: its attention layers
    return info


# ------------------------------------------------------------ LM on a device mesh

#: Phase lm_mesh's bars against the one-device run from the same seed, batches
#: and init. Training: the loss within rtol 1e-4 and the gradient norm within
#: rtol 1e-3 on each step. Both sides do the same f32 arithmetic; they differ
#: in the order of the cross-shard sums and in cuBLAS's sums over other
#: operand shapes (a few ulps a product), which Adam's first steps magnify
#: where |g| is near eps (an element can move by up to 2 lr). Serving: the
#: prefill and the teacher-forced decode logits within 1e-4 * max|logits|,
#: the kernel-vs-plain bar of phase lm_serve (the bf16 cache rounds the same
#: k, v but for a last f32 place). The sequence-sharded decode: 2e-3, the
#: reference's bar (tests/test_distributed_subprocess.py); the int8 DDP and
#: the pipeline: the reference's bars (final loss < 1e-2, parameter error
#: < 0.05; output < 1e-5, gradient < 1e-4).
MESH_LOSS_RTOL, MESH_GNORM_RTOL, MESH_SERVE_RTOL = 1e-4, 1e-3, 1e-4


def mesh_of(shape, device):
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(*shape, device)


def mesh_training(c, mcfg, device, seed) -> tuple[dict, object]:
    """(a) ``c["steps"]`` AdamW steps on ``batch`` x ``seq`` tokens from
    phase lm_train (a)'s seeded init and batches, on one device and on each
    mesh of logical shards of the device (``make_host_mesh``): the loss and
    the gradient norm of every step against one device's, s a step, peak
    bytes, flash launches (two a layer a coordinate a step under remat).
    Returns the info and the last mesh's (params, opt_state, opt_cfg)."""
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.distributed import parallel
    from repro_torch.optim import adamw

    flash = _flash()
    runs, kept = {}, None
    for shape in [None, *c["meshes"]]:
        model, opt, step_fn = train_parts(mcfg, c["lr"], c["steps"], seed, device)
        if shape is not None:
            model = parallel.shard_model(mesh_of(shape, device), model)
            opt = parallel.shard_opt_state(model, opt)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        data = batch_iterator(mcfg, c["batch"], c["seq"], 0, device)
        flash.launches = 0
        losses, times, metrics = [], [], []
        for _ in range(c["steps"]):
            batch = next(data)
            t0 = time.perf_counter()
            model, opt, m = step_fn(model, opt, batch)
            sync(device)
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            metrics.append({k: float(v) for k, v in m.items()})
        name = "one_device" if shape is None else f"{shape[0]}x{shape[1]}"
        D, M = shape or (1, 1)
        per_step = (2 if mcfg.remat == "full" else 1) * mcfg.num_layers * D * M
        runs[name] = dict(losses=losses, grad_norm=[m["grad_norm"] for m in metrics],
                          step_s=times, step_s_median=float(np.median(times[1:])),
                          peak_device_bytes=torch.cuda.max_memory_allocated(device)
                          if device.type == "cuda" else None,
                          flash_launches=flash.launches, flash_launches_expected=per_step
                          * c["steps"])
        if device.type == "cuda" and flash.launches != per_step * c["steps"]:
            raise AssertionError(f"{name}: flash_attention_bhsd ran {flash.launches} times, "
                                 f"expected {per_step * c['steps']}")
        if shape is not None:
            one = runs["one_device"]
            dl = [abs(a - b) / abs(b) for a, b in zip(losses, one["losses"])]
            dg = [abs(a - b) / abs(b) for a, b in zip(runs[name]["grad_norm"], one["grad_norm"])]
            runs[name].update(loss_rel_diff=dl, grad_norm_rel_diff=dg)
            if max(dl) > MESH_LOSS_RTOL or max(dg) > MESH_GNORM_RTOL:
                raise AssertionError(f"{name} vs one device: loss {dl}, grad norm {dg}")
        if shape == tuple(c["elastic_from"]):
            kept = (model, opt, adamw.AdamWConfig(lr=c["lr"], moments_dtype=mcfg.moments_dtype))
        else:
            del model, opt
    if not all(np.isfinite(runs["one_device"]["losses"])):
        raise AssertionError(f"one device: losses {runs['one_device']['losses']}")
    return dict(batch=c["batch"], seq=c["seq"], steps=c["steps"], lr=c["lr"],
                limits=dict(loss_rtol=MESH_LOSS_RTOL, grad_norm_rtol=MESH_GNORM_RTOL),
                runs=runs), kept


def mesh_serving(c, mcfg, device, seed) -> tuple[dict, object]:
    """(b) ``serve.generate`` of a ``serve_batch`` x ``serve_prompt`` prompt
    and ``serve_gen`` greedy steps on one device and on a ``serve_mesh``
    mesh; the mesh's prefill logits and its decode logits teacher-forced on
    the one-device tokens against the one-device logits. Returns the info
    and the one-device model."""
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.distributed import parallel
    from repro_torch.launch import serve
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY

    flash = _flash()
    model = lm.init(torch.Generator(device=device).manual_seed(seed), mcfg, TEST_POLICY, device)
    prompt = {"tokens": torch.as_tensor(
        synthetic_batch(mcfg, 0, c["serve_batch"], c["serve_prompt"])["tokens"], device=device)}
    one = serve.generate(model, mcfg, TEST_POLICY, prompt, c["serve_gen"])
    mesh = parallel.shard_model(mesh_of(c["serve_mesh"], device), model)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    flash.launches = 0
    res = serve.generate(mesh, mcfg, TEST_POLICY, prompt, c["serve_gen"])
    launches = flash.launches
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    forced = teacher_forced(mesh, mcfg, TEST_POLICY, prompt, one.tokens)
    del mesh
    scale = float(one.logits.abs().max())
    prefill_diff = float((res.logits[0] - one.logits[0]).abs().max())
    forced_diff = float((forced - one.logits).abs().max())
    D, M = c["serve_mesh"]
    if device.type == "cuda" and launches != mcfg.num_layers * D * M:
        raise AssertionError(f"mesh prefill: flash_attention_bhsd ran {launches} times")
    if max(prefill_diff, forced_diff) > MESH_SERVE_RTOL * scale:
        raise AssertionError(f"mesh serving vs one device: prefill {prefill_diff}, "
                             f"teacher-forced decode {forced_diff} (max |logit| {scale})")
    return dict(mesh=list(c["serve_mesh"]), batch=c["serve_batch"], prompt=c["serve_prompt"],
                gen=c["serve_gen"], one_device=dict(prefill_s=one.prefill_s,
                                                    decode_ms_per_step=one.decode_s
                                                    / c["serve_gen"] * 1e3),
                on_mesh=dict(prefill_s=res.prefill_s,
                             decode_ms_per_step=res.decode_s / c["serve_gen"] * 1e3,
                             peak_device_bytes=peak),
                flash_launches=launches, logits_abs_max=scale,
                prefill_max_abs_diff=prefill_diff, teacher_forced_max_abs_diff=forced_diff,
                limit=MESH_SERVE_RTOL * scale,
                greedy_agreement=float((res.tokens == one.tokens).float().mean())), model


def mesh_seq_decode(c, mcfg, model, device, seed) -> dict:
    """(c) batch 1 against a ``seq_cache``-position bf16 cache filled with
    0.1 N(0, 1) (the reference's check_seq_sharded_decode_matches), the
    token at the last position: one device against a ``seq_mesh`` mesh whose
    data shards keep T / D positions each."""
    from repro_torch.distributed import parallel
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY

    T = c["seq_cache"]
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    cache = lm.init_cache(mcfg, 1, T, torch.bfloat16, device)
    for group in cache:
        for state in group.values():
            for x in state.values():
                x.copy_(torch.randn(x.shape, generator=gen, device=device) * 0.1)
    nbytes = sum(x.numel() * x.element_size() for g in cache for s in g.values()
                 for x in s.values())
    p = parallel.shard_model(mesh_of(c["seq_mesh"], device), model)
    mc = parallel.place_cache(p, cache, True)  # its blocks are copies
    step = {"tokens": torch.tensor([[17]], device=device)}
    with torch.inference_mode():
        t0 = time.perf_counter()
        got, _ = parallel.forward_decode(p, TEST_POLICY, step, mc, T - 1)
        sync(device)
        mesh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want, _ = lm.forward_decode(model, mcfg, TEST_POLICY, step, cache, T - 1)
        sync(device)
        one_s = time.perf_counter() - t0
    del p, mc, cache
    diff = float((got - want).abs().max())
    if not diff < 2e-3:
        raise AssertionError(f"sequence-sharded decode vs one device: {diff}")
    return dict(mesh=list(c["seq_mesh"]), cache_positions=T, cache_bytes=nbytes,
                positions_a_shard=T // c["seq_mesh"][0], max_abs_diff=diff, limit=2e-3,
                mesh_decode_s=mesh_s, one_device_decode_s=one_s)


def mesh_ddp(c, device) -> dict:
    """(d) the reference's check_compressed_ddp_converges on a ``ddp_mesh``
    of logical shards: int8 error-feedback gradients, ``ddp_steps`` steps."""
    from repro_torch.distributed import compression

    mesh = mesh_of(c["ddp_mesh"], device)
    target = torch.arange(8.0, device=device)

    def loss_fn(params, batch):
        return torch.mean((batch @ params - batch @ target.to(batch.device)) ** 2)

    def opt_update(params, grads, opt_state):
        return params - 0.05 * grads.to(params.device), opt_state

    step = compression.make_ddp_compressed_step(mesh, loss_fn, opt_update, axes=("data",))
    params = torch.zeros(8, device=device)
    err = compression.init_error_state(params)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(c["ddp_steps"]):
        batch = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32)).to(device)
        params, _, err, loss = step(params, None, err, batch)
    sync(device)
    secs = time.perf_counter() - t0
    final, perr = float(loss), float((params - target).abs().max())
    if not (final < 1e-2 and perr < 0.05):
        raise AssertionError(f"int8 DDP: final loss {final}, parameter error {perr}")
    shards = c["ddp_mesh"][0]
    return dict(mesh=list(c["ddp_mesh"]), steps=c["ddp_steps"], final_loss=final,
                param_error=perr, limits=dict(final_loss=1e-2, param_error=0.05),
                s_per_step=secs / c["ddp_steps"],
                payload_bytes_per_step=dict(int8=shards * (8 * 1 + 4), f32=shards * 8 * 4))


def mesh_pipeline(c, device) -> dict:
    """(e) the reference's check_pipeline_matches_unpipelined: 4 tanh stages
    on the ``pipe`` axis of a (4, 1) mesh of logical shards, 6 microbatches."""
    from repro_torch.distributed.pipeline import pipelined_apply
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4, 1), ("pipe", "model"), devices=[device] * 4)
    rng = np.random.default_rng(7)
    Ws = torch.from_numpy((rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)).to(device)
    x = torch.from_numpy(rng.standard_normal((6, 8, 16)).astype(np.float32)).to(device)

    def stage_fn(W, h):
        return torch.tanh(h @ W)

    def chain(W):
        h = x
        for s in range(4):
            h = stage_fn(W[s], h)
        return h

    W1, W2 = Ws.clone().requires_grad_(True), Ws.clone().requires_grad_(True)
    out = pipelined_apply(mesh, stage_fn, W1, x)
    (g,) = torch.autograd.grad(torch.sum(out ** 2), W1)
    want = chain(W2)
    (g_ref,) = torch.autograd.grad(torch.sum(want ** 2), W2)
    err, gerr = float((out - want).abs().max()), float((g - g_ref).abs().max())
    if not (err < 1e-5 and gerr < 1e-4):
        raise AssertionError(f"pipeline: output {err}, gradient {gerr}")
    return dict(stages=4, microbatches=6, max_err=err, grad_err=gerr,
                limits=dict(max_err=1e-5, grad_err=1e-4))


def mesh_elastic(c, mcfg, kept, device) -> dict:
    """(f) the (a) run's state on its ``elastic_from`` mesh saved as
    ``TrainLoop`` saves it (the gathered trees, the reference's layout), then
    ``reshard_restore`` onto each ``elastic_to`` mesh: every parameter and
    moment bit for bit."""
    import shutil
    import tempfile

    from repro_torch import convert
    from repro_torch.distributed import checkpoint as ckpt_lib
    from repro_torch.launch import elastic
    from repro_torch.models.common import TEST_POLICY
    from repro_torch.optim.adamw import AdamWState

    params, opt, opt_cfg = kept
    root = Path(tempfile.mkdtemp(prefix="lm_mesh_"))
    try:
        t0 = time.perf_counter()
        gathered = AdamWState(opt.step, {n: s.gather("cpu") for n, s in opt.mu.items()},
                              {n: s.gather("cpu") for n, s in opt.nu.items()})
        trees = convert.lm_train_state_to_numpy(params.gather("cpu"), gathered, mcfg)
        del params, opt, gathered
        ckpt_lib.save(root, int(trees["opt_state"].step), trees)
        save_s = time.perf_counter() - t0
        saved = dict(params=convert._by_name(trees["params"], mcfg),
                     mu=convert._by_name(trees["opt_state"].mu, mcfg),
                     nu=convert._by_name(trees["opt_state"].nu, mcfg))
        out = dict(mesh_from=list(c["elastic_from"]), bytes=dir_bytes(root), save_s=save_s,
                   restores={})
        for shape in c["elastic_to"]:
            t0 = time.perf_counter()
            step, p, o = elastic.reshard_restore(root, mcfg, TEST_POLICY, opt_cfg,
                                                 mesh_of(shape, device))
            sync(device)
            restore_s = time.perf_counter() - t0
            equal = all(np.array_equal(src[n].gather("cpu").numpy(), want)
                        for src, key in ((p.params, "params"), (o.mu, "mu"), (o.nu, "nu"))
                        for n, want in saved[key].items())
            out["restores"][f"{shape[0]}x{shape[1]}"] = dict(
                restore_s=restore_s, step=step, bitwise_equal=equal)
            del p, o
            if not equal or step != int(trees["opt_state"].step):
                raise AssertionError(f"elastic restore onto {shape}: not bit for bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["temp_dir_removed"] = not root.exists()
    return out


def phase_lm_mesh(cfg, device, seed) -> dict:
    """The LM on a device mesh (``distributed.parallel``) over logical shards
    of the one device (``make_host_mesh(data, model, device)``): qwen1.5-0.5b
    at full width and depth on the card (reduced in the rehearsal), (a)
    training on three meshes, (b) serving on (1, 2), (c) the
    sequence-sharded decode on (2, 1), (d) int8 error-feedback DDP on (8, 1),
    (e) the GPipe pipeline on a (4, 1) pipe axis, (f) the elastic restore
    from (2, 2) onto (1, 2) and (1, 1). TF32 stays off."""
    from repro_torch.configs import get_arch, reduced

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: the mesh is held against one device in f32")
    c = cfg["lm_mesh"]
    arch = get_arch(c["arch"])
    mcfg = reduced(arch) if c["reduced"] else arch
    info = dict(phase="lm_mesh", arch=mcfg.name, layers=mcfg.num_layers, d_model=mcfg.d_model,
                heads=mcfg.num_heads, remat=mcfg.remat, device_entries="logical shards of one "
                "device" if device.type == "cuda" else "cpu")
    kept, model = None, None
    parts = (("a_training", lambda: mesh_training(c, mcfg, device, seed)),
             ("b_serving", lambda: mesh_serving(c, mcfg, device, seed)),
             ("c_seq_sharded_decode", lambda: mesh_seq_decode(c, mcfg, model, device, seed)),
             ("d_int8_ddp", lambda: mesh_ddp(c, device)),
             ("e_pipeline", lambda: mesh_pipeline(c, device)),
             ("f_elastic", lambda: mesh_elastic(c, mcfg, kept, device)))
    for key, part in parts:
        t0 = time.perf_counter()
        try:
            res = part()
        except BaseException:
            print(json.dumps(info), file=sys.stderr, flush=True)  # the parts that passed
            raise
        if key == "a_training":
            res, kept = res
        elif key == "b_serving":
            res, model = res
        elif key == "f_elastic":
            kept = None
        info[key] = res
        if device.type == "cuda":
            torch.cuda.empty_cache()
        info[f"{key}_s"] = time.perf_counter() - t0
    del model
    info["flash_launches"] = (sum(r["flash_launches"] for r in info["a_training"]["runs"].values())
                              + info["b_serving"]["flash_launches"])
    return info


# ------------------------------------------------------------ SSM layers on a device mesh

#: Phase lm_mesh_ssm's serving bars against one device, on the prefill
#: logits and every teacher-forced decode step: f32 (g) as lm_mesh (b),
#: 1e-4 * max|logits|, with the SSM states and the attention's k, v cached
#: in f32 on both sides (``f32_states``, ``f32_cache``): a shard's GEMMs of
#: another width move the residual stream and k, v in their last f32 place,
#: which the default bf16 x_tmix, x_cmix and k, v can round one bf16 ulp
#: apart (on the card, rwkv6's decode logits 1.0e-3 of 5.2 apart against a
#: 1.8e-4 prefill; jamba's f32 layers 3.5e-3 of 10.4 against 8.1e-5), as
#: the KV-heads case of tests/test_torch_mesh_lm.py keeps its cache f32. The jamba group in bf16
#: (h) is held to no tolerance: its logits are bf16 (one ulp at the largest
#: is 3.9e-3 of it), a model shard's partial sums round to bf16 before their
#: sum as the reference's all-reduce does, and a last-ulp change of a router
#: logit flips a near-tie top-2 choice (on the first card run the prefill
#: logits differed by 0.95 of 8.94, greedy tokens agreed on 3 %). Its diffs
#: are reported, unpinned and with one device's routing replayed on the
#: mesh; jamba's Mamba + MoE and attention + dense layers at full width in
#: f32 (h, f32) carry the 1e-4 bar.


def shard_freeing(mesh, model):
    """``parallel.shard_model``, each of the model's parameters freed once
    its blocks are placed: one copy of the weights on the card at a time."""
    from repro_torch.distributed import parallel
    from repro_torch.distributed import sharding as shd

    named = dict(model.named_parameters())
    specs = shd.param_pspecs(model.cfg, named)
    placed = {}
    for name, x in named.items():
        placed[name] = shd.place_leaf(mesh, x, specs[name], name)
        x.data = torch.empty(0, dtype=x.dtype, device=x.device)
    return parallel.MeshLM(model.cfg, mesh, placed)


def peak_bytes(device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def fresh_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def mesh_ssm_serving(spec, mcfg, device, seed) -> dict:
    """(g) / (h): ``serve.generate`` of ``batch`` x ``prompt`` + ``gen`` greedy
    steps on one device, its logits kept on the host and the model freed;
    then, for each mesh, the model drawn again from the seed and placed leaf
    by leaf (``shard_freeing``), ``generate`` timed, and its prefill logits
    and the decode logits teacher-forced on the one-device tokens held
    against one device's. Flash launches counted on each run: one a prefill
    per attention layer and coordinate."""
    from repro_torch.models.common import TEST_POLICY, Policy

    bf16 = spec.get("dtype") == "bfloat16"
    policy = Policy(torch.bfloat16, torch.bfloat16) if bf16 else TEST_POLICY
    with contextlib.ExitStack() as stack:
        if not bf16:  # the caches f32 on both sides (MESH_SERVE_RTOL's note above)
            stack.enter_context(f32_states())
            stack.enter_context(f32_cache())
        return _mesh_ssm_serving(spec, mcfg, policy, None if bf16 else MESH_SERVE_RTOL,
                                 device, seed)


@contextlib.contextmanager
def routing(record=None, replay=None, calls_per_route=1):
    """``moe.route`` inside the block: each call's ``Routing`` appended to
    ``record``, or the ``replay`` list's entries returned in order, one for
    every ``calls_per_route`` calls (a mesh's coordinates route a layer's
    tokens once each, the same tokens when the data axis is 1)."""
    from repro_torch.models import moe

    route, n = moe.route, [0]

    def wrapped(*a, **kw):
        if replay is not None:
            r = replay[n[0] // calls_per_route]
            n[0] += 1
            return r
        r = route(*a, **kw)
        record.append(r)
        return r

    with patched(moe, "route", wrapped):
        yield


def _mesh_ssm_serving(spec, mcfg, policy, rtol, device, seed) -> dict:
    from repro_torch.launch import serve
    from repro_torch.models import model as lm

    flash = _flash()
    B, S, gen = spec["batch"], spec["prompt"], spec["gen"]
    attn_layers = sum(s.mixer == "attn" for s in mcfg.layer_pattern()) * mcfg.num_groups

    def draw():
        return lm.init(torch.Generator(device=device).manual_seed(seed), mcfg, policy, device)

    batch = lm_inputs(mcfg, B, S, device)
    fresh_peak(device)
    model = draw()
    params = lm.param_count(model)
    flash.launches = 0
    routes: list = []
    with routing(record=routes):
        one = serve.generate(model, mcfg, policy, batch, gen)
    out = dict(arch=mcfg.name, layers=mcfg.num_layers, d_model=mcfg.d_model,
               experts=None if mcfg.moe is None else mcfg.moe.num_experts,
               dtype=str(policy.param_dtype).replace("torch.", ""), batch=B, prompt=S, gen=gen,
               cache_dtypes="f32" if policy.compute_dtype == torch.float32 else "default",
               params=params,
               one_device=dict(prefill_s=one.prefill_s, decode_ms_per_step=one.decode_s / gen * 1e3,
                               flash_launches=flash.launches, peak_device_bytes=peak_bytes(device)),
               meshes={})
    logits, tokens = one.logits.float().cpu(), one.tokens
    scale = float(logits.abs().max())
    del model, one
    for shape in spec["meshes"]:
        fresh_peak(device)
        p = shard_freeing(mesh_of(shape, device), draw())
        flash.launches = 0
        res = serve.generate(p, mcfg, policy, batch, gen)
        launches = flash.launches
        forced = teacher_forced(p, mcfg, policy, batch, tokens).float().cpu()
        run = dict(prefill_s=res.prefill_s, decode_ms_per_step=res.decode_s / gen * 1e3,
                   flash_launches=launches, peak_device_bytes=peak_bytes(device),
                   prefill_max_abs_diff=float((res.logits[0].float().cpu() - logits[0])
                                              .abs().max()),
                   teacher_forced_max_abs_diff=float((forced - logits).abs().max()),
                   greedy_agreement=float((res.tokens == tokens).float().mean()))
        D, M = shape
        if routes and D == 1:  # the mesh's MoE fed one device's routing
            with routing(replay=routes, calls_per_route=M):
                pinned = teacher_forced(p, mcfg, policy, batch, tokens).float().cpu()
            run["routing_replayed"] = dict(
                prefill_max_abs_diff=float((pinned[0] - logits[0]).abs().max()),
                teacher_forced_max_abs_diff=float((pinned - logits).abs().max()))
            del pinned
        del p, res, forced
        out["meshes"][f"{D}x{M}"] = run
        if device.type == "cuda" and launches != attn_layers * D * M:
            raise AssertionError(f"{mcfg.name} on {shape}: flash_attention_bhsd ran {launches} "
                                 f"times, expected {attn_layers * D * M}")
        if not (np.isfinite(run["prefill_max_abs_diff"])
                and np.isfinite(run["teacher_forced_max_abs_diff"])):
            raise AssertionError(f"{mcfg.name} on {shape}: non-finite logits")
        if rtol is not None and max(run["prefill_max_abs_diff"],
                                    run["teacher_forced_max_abs_diff"]) > rtol * scale:
            raise AssertionError(f"{mcfg.name} on {shape} vs one device: {run} "
                                 f"(max |logit| {scale}, rtol {rtol})")
    out.update(logits_abs_max=scale, rtol=rtol, limit=None if rtol is None else rtol * scale,
               bf16_ulp_at_max=scale * 2.0 ** -8)
    return out


def mesh_ssm_training(t, name, mcfg, device, seed) -> dict:
    """(i): one AdamW step of ``mcfg`` on ``batch`` x ``seq`` tokens on one
    device, then on each mesh from the same seed and batch: the loss and the
    gradient norm against one device's at lm_mesh (a)'s bars."""
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.distributed import parallel

    batch = next(batch_iterator(mcfg, t["batch"], t["seq"], 0, device))
    runs = {}
    for shape in [None, *t["meshes"]]:
        fresh_peak(device)
        model, opt, step_fn = train_parts(mcfg, t["lr"], 1, seed, device)
        if shape is not None:
            model = parallel.shard_model(mesh_of(shape, device), model)
            opt = parallel.shard_opt_state(model, opt)
        t0 = time.perf_counter()
        _, _, m = step_fn(model, opt, batch)
        sync(device)
        run = dict(step_s=time.perf_counter() - t0, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]), peak_device_bytes=peak_bytes(device))
        del model, opt, m
        key = "one_device" if shape is None else f"{shape[0]}x{shape[1]}"
        if shape is not None:
            one = runs["one_device"]
            run.update(loss_rel_diff=abs(run["loss"] - one["loss"]) / abs(one["loss"]),
                       grad_norm_rel_diff=abs(run["grad_norm"] - one["grad_norm"])
                       / abs(one["grad_norm"]))
            if run["loss_rel_diff"] > MESH_LOSS_RTOL or run["grad_norm_rel_diff"] > MESH_GNORM_RTOL:
                raise AssertionError(f"{name} on {shape} vs one device: {run}")
        elif not np.isfinite(run["loss"]):
            raise AssertionError(f"{name}: loss {run['loss']}")
        runs[key] = run
    return dict(arch=mcfg.name, layers=mcfg.num_layers, d_model=mcfg.d_model,
                pattern=[f"{s.mixer}+{s.ffn}" for s in mcfg.layer_pattern()],
                batch=t["batch"], seq=t["seq"], runs=runs,
                limits=dict(loss_rtol=MESH_LOSS_RTOL, grad_norm_rtol=MESH_GNORM_RTOL))


def phase_lm_mesh_ssm(cfg, device, seed) -> dict:
    """Mamba and RWKV6 layers under a model axis, on logical shards of the
    one device: (g) rwkv6-3b whole (f32) served on (1, 2) and (2, 2), (h)
    one jamba-1.5-large-398b group (bf16, 4 of 16 experts) on (1, 2), and
    its layers 3 and 4 (Mamba + MoE, attention + dense) at full width in f32
    on (1, 2), each against one device; (i) one train step of each arch on 2 layers, on
    (1, 2) and (2, 2) against one device (rwkv6 at full width, jamba's first
    two layers, a Mamba + dense and a Mamba + MoE, at a quarter of its
    width). TF32 stays off."""
    import dataclasses

    from repro_torch.configs.base import LayerSpec

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: the mesh is held against one device in f32")
    c = cfg["lm_mesh_ssm"]
    t = c["train"]
    rwkv = cut_arch("rwkv6-3b", c["rwkv"], c["reduced"])
    jamba = cut_arch("jamba-1.5-large-398b", c["jamba"], c["reduced"])
    jamba_f32 = cut_arch("jamba-1.5-large-398b", c["jamba_f32"], c["reduced"],
                             num_layers=2, pattern=(LayerSpec("mamba", "moe"),
                                                    LayerSpec("attn", "dense")))
    rwkv_train = cut_arch("rwkv6-3b", t, c["reduced"], num_layers=t["layers"])
    width = t["jamba_width"]
    jamba_train = cut_arch(
        "jamba-1.5-large-398b", dict(t, experts=t["jamba_experts"]), c["reduced"],
        num_layers=t["layers"], d_model=width, d_ff=3 * width,
        pattern=(LayerSpec("mamba", "dense"), LayerSpec("mamba", "moe")))
    jamba_train = dataclasses.replace(jamba_train, moe=dataclasses.replace(
        jamba_train.moe, d_ff_expert=3 * width))
    info = dict(phase="lm_mesh_ssm", device_entries="logical shards of one device"
                if device.type == "cuda" else "cpu")
    parts = (("g_rwkv6", lambda: mesh_ssm_serving(c["rwkv"], rwkv, device, seed)),
             ("h_jamba", lambda: mesh_ssm_serving(c["jamba"], jamba, device, seed)),
             ("h_jamba_f32", lambda: mesh_ssm_serving(c["jamba_f32"], jamba_f32, device, seed)),
             ("i_training", lambda: {"rwkv6": mesh_ssm_training(t, "rwkv6", rwkv_train,
                                                                device, seed),
                                     "jamba": mesh_ssm_training(t, "jamba", jamba_train,
                                                                device, seed)}))
    for key, part in parts:
        t0 = time.perf_counter()
        try:
            info[key] = part()
        except BaseException:
            print(json.dumps(info), file=sys.stderr, flush=True)  # the parts that passed
            raise
        info[f"{key}_s"] = time.perf_counter() - t0
    info["flash_launches"] = sum(
        info[k]["one_device"]["flash_launches"] + sum(r["flash_launches"]
                                                      for r in info[k]["meshes"].values())
        for k in ("g_rwkv6", "h_jamba", "h_jamba_f32"))
    return info


# ------------------------------------------------------------ the dry-run


def card_route(device):
    """On the CPU (the rehearsal), the attention through the card's route
    inside the block: the op the dry-run counts in place of the launch,
    ``FlashAttention`` under grad; on a card, nothing changes."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops

    stack = contextlib.ExitStack()
    if device.type == "cpu":
        def bhsd(q, k, v, *, window=0):
            return torch.ops.repro_torch.flash_attention(q, k, v, window)

        def routed(q, k, v, *, window=0):
            if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
                return flash.FlashAttention.apply(q, k, v, window)
            return bhsd(q, k, v, window=window)

        stack.enter_context(patched(flash, "flash_attention_bhsd", bhsd))
        stack.enter_context(patched(ops, "flash_attention", routed))
    return stack


def phase_dryrun(cfg, device, seed, background=None) -> dict:
    """The dry-run's count of lm_mesh (a)'s cell held against the card: one
    AdamW step of qwen1.5-0.5b (f32, the card's policy) on ``batch`` x
    ``seq`` tokens on a ``mesh`` of ``meta`` devices, counted by
    ``launch.dryrun.count``, and the same step on the same mesh of logical
    shards of the card under ``FlopCounterMode``. Gated: each coordinate's
    parameter and optimizer bytes from the specs equal the bytes of the
    blocks the card run holds there, and the GEMM flops (``aten.mm``,
    ``bmm``, ``addmm``) are equal. Printed: the step's time beside the
    record's roofline terms. Then ``cells`` of the dry-run itself on
    ``meta`` (production meshes): status and wall s each, from the workers ``start_dryrun_cells`` started (``background``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_arch, reduced
    from repro_torch.distributed import parallel
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as lm
    from repro_torch.models.common import TEST_POLICY
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline import analysis

    c = cfg["dryrun"]
    arch = reduced(get_arch(c["arch"])) if c["reduced"] else get_arch(c["arch"])
    opt_cfg = AdamWConfig(moments_dtype=arch.moments_dtype)
    D, M = c["mesh"]
    axes = ("data", "model")
    from repro_torch.data.tokens import batch_iterator

    batch = next(batch_iterator(arch, c["batch"], c["seq"], 0, device))
    meta_mesh = make_mesh((D, M), axes, devices=["meta"] * (D * M))
    p_meta = parallel.shard_model(meta_mesh, lm.build(arch, TEST_POLICY, device="meta"))
    counted = dryrun.count(dryrun.prepare_step(
        arch, TEST_POLICY, opt_cfg, p_meta, "train",
        {k: torch.empty_like(v, device="meta") for k, v in batch.items()}))
    spec_param, spec_opt = dryrun.state_bytes(arch, TEST_POLICY, opt_cfg, meta_mesh)
    del p_meta

    fresh_peak(device)
    model = lm.init(torch.Generator(device=device).manual_seed(seed), arch, TEST_POLICY, device)
    card_mesh = make_mesh((D, M), axes, devices=[device] * (D * M))
    p = parallel.shard_model(card_mesh, model)
    del model
    coords = [tuple(int(i) for i in ix) for ix in np.ndindex(D, M)]
    blocks = {}
    state = dryrun.opt_state_like(p, opt_cfg)
    for at in coords:
        blocks[str(at)] = dict(param=dryrun.block_bytes(p.params, at),
                               opt_state=4 + dryrun.block_bytes(state.mu, at)
                               + dryrun.block_bytes(state.nu, at))
    del state
    bad = {k: v for k, v in blocks.items()
           if v != dict(param=spec_param, opt_state=spec_opt)}
    if bad:
        raise AssertionError(f"dry-run bytes from the specs ({spec_param}, {spec_opt}) differ "
                             f"from the card's blocks at {bad}")
    step = dryrun.prepare_step(arch, TEST_POLICY, opt_cfg, p, "train", batch)
    with FlopCounterMode(display=False) as fc, card_route(device):
        step()
    card_ops = {str(k): int(v) for k, v in fc.get_flop_counts()["Global"].items()}
    card_gemm = sum(v for k, v in card_ops.items() if k in ("aten.mm", "aten.bmm", "aten.addmm"))
    if card_gemm != counted["gemm_flops"]:
        raise AssertionError(f"GEMM flops: meta {counted['gemm_flops']}, card {card_gemm} "
                             f"({counted['flops_by_op']} against {card_ops})")
    times = []
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        step()
        sync(device)
        times.append(time.perf_counter() - t0)
    peak = peak_bytes(device)
    del p, step
    n = D * M
    terms = analysis.roofline_terms(flops=counted["flops"], bytes_hbm=counted["hbm_bytes"],
                                    collective_bytes=0.0, peak_flops=analysis.PEAK_FLOPS)
    gate = dict(arch=arch.name, policy="float32", batch=c["batch"], seq=c["seq"], mesh=[D, M],
                per_coordinate_bytes=dict(spec=dict(param=spec_param, opt_state=spec_opt),
                                          card_blocks=blocks),
                gemm_flops=dict(meta=counted["gemm_flops"], card=card_gemm),
                flops_by_op=dict(meta=counted["flops_by_op"], card=card_ops),
                meta_count_s=counted["wall_s"],
                record_per_device=dict(flops=counted["flops"] / n,
                                       hbm_bytes=counted["hbm_bytes"] / n,
                                       collective_bytes=counted["collective_bytes"] / n),
                whole_mesh_on_one_card=dict(t_compute_s=terms["t_compute_s"],
                                            t_memory_s=terms["t_memory_s"],
                                            peak="f32 67 TFLOP/s, 3.35 TB/s"),
                step_s=times, step_s_median=float(np.median(times)), peak_device_bytes=peak)
    info = dict(phase="dryrun", a_card_vs_meta=gate)
    if background is not None:
        pool, jobs, started = background
        cells = []
        for (a, s, mp), fut in jobs:
            rec, tb = fut.result()
            if rec["status"] == "fail":
                raise AssertionError(f"dry-run {a} x {s} x {mp}: {rec['error']}\n{tb}")
            if rec["status"] == "skipped" and s in get_arch(a).runnable_shapes():
                raise AssertionError(f"dry-run {a} x {s}: skipped")
            cells.append(dict(arch=a, shape=s, multi_pod=mp, status=rec["status"],
                              wall_s=rec.get("wall_s"), flops=rec.get("flops"),
                              collective_bytes=rec.get("collective_bytes")))
        pool.shutdown()
        info.update(b_cells=cells, b_cells_since_start_s=time.perf_counter() - started)
    return info


def start_dryrun_cells(cfg):
    """Phase dryrun's ``cells`` of the dry-run on ``meta``, started in
    ``jobs`` worker processes at the lowest CPU priority, so that they run
    beside the card's phases that follow: (pool, [((arch, shape,
    multi_pod), future)], start time), or None when there are none."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.launch import dryrun

    c = cfg["dryrun"]
    if not c["cells"]:
        return None
    pool = concurrent.futures.ProcessPoolExecutor(
        c["jobs"], mp_context=multiprocessing.get_context("spawn"), initializer=os.nice,
        initargs=(19,))
    return pool, [(cell, pool.submit(dryrun._cell, (*cell, ()))) for cell in c["cells"]], \
        time.perf_counter()


def profile_serve(model, cfg, policy, prompt, tokens, steps=4) -> dict:
    """Where serving time goes: one prefill (with the cache set-up) and
    ``steps`` decode steps after it, each traced (device busy share, the
    top kernels)."""
    from repro_torch.launch import serve
    from repro_torch.models import model as lm

    S = prompt.shape[1]
    with torch.inference_mode():
        (_, cache), prefill = device_profile(
            lambda: serve.prefill(model, cfg, policy, {"tokens": prompt}, S + steps))

        def decode():
            for i in range(steps):
                lm.forward_decode(model, cfg, policy, {"tokens": tokens[:, i:i + 1]}, cache, S + i)

        _, dec = device_profile(decode)
    return dict(prefill=prefill, decode_steps=steps, decode=dec)


def _iters(res) -> np.ndarray:
    """Lloyd iterations per candidate, (len(k_grid), restarts)."""
    return np.asarray([[m.meta.iters for m in row] for row in res.models])


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 300) -> float:
    """Host time of one call, in us: ``iters`` calls on the host clock, the
    card synchronized before and after (so it measures the launches, not the
    kernels, while the card keeps up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def device_profile(run) -> dict:
    """Wall time of ``run()`` (ending in a synchronize) under torch.profiler,
    the card's kernel time in it (busy share = kernel ms over wall ms), the
    host -> device copy time on the copy engine, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel, counts, h2d_ms = {}, {}, 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # kernels only: ops would count twice
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if "Memcpy HtoD" in ev.key:
            h2d_ms += us / 1e3
        elif us > 0 and not ev.key.startswith("Memcpy"):
            per_kernel[ev.key[:60]] = us / 1e3
            counts[ev.key[:60]] = ev.count
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return out, dict(wall_ms=wall * 1e3,
                     device_busy_ms=busy_ms if busy_ms else "not measured",
                     device_busy_share=busy_ms / (wall * 1e3) if busy_ms else "not measured",
                     h2d_copy_ms=h2d_ms if h2d_ms else "not measured",
                     top_device_ms=dict(top), kernel_launches=counts)


def profile_lloyd(Y, k, iters=20) -> dict:
    """Device busy share of a Lloyd run over the resident Y, the kernels it
    launched (kernel_launches) and the device ms of one launch of the assign
    kernel and of its reduce (over the resident X). Gated: one apnc_assign
    launch a step and no GEMM (the cost comes out of the assign launch, not
    a second pass)."""
    from repro_torch.core.lloyd import kmeanspp_init, lloyd
    from repro_torch.kernels import apnc_assign

    init = kmeanspp_init(torch.Generator().manual_seed(3), Y[:1024], k, "l2")
    lloyd(Y, k, discrepancy="l2", iters=2, init=init)  # warm-up
    before = apnc_assign.launches
    res, prof = device_profile(lambda: lloyd(Y, k, discrepancy="l2", iters=iters, init=init))
    launched = apnc_assign.launches - before
    gemms = [name for name in prof["kernel_launches"] if "gemm" in name.lower()]
    if launched != res.iters + 1 or gemms:
        raise AssertionError(f"a traced local Lloyd of {res.iters} steps launched apnc_assign "
                             f"{launched} times and the GEMMs {gemms}")
    top, counts = prof["top_device_ms"], prof["kernel_launches"]
    per_launch = {name: top[key] / counts[key] for key in top
                  for name in ("assign_kernel", "lloyd_reduce_kernel") if name in key}
    return dict(iters=res.iters, apnc_assign_launches=launched,
                apnc_assign_device_ms_per_launch=per_launch, **prof)


def profile_stream_pass(store, est, device, devices=None) -> dict:
    """One Lloyd pass of the stream fit (every block through the fused step,
    the (Z, g, cost) combine and the label copy-out), traced: where a pass's
    wall time goes between the card's kernels, the copy engine and the host.
    ``devices``: the pass sharded over them (their shuffle included)."""
    from repro_torch.kernels import ops
    from repro_torch.stream import engine, lloyd, sharded

    cell = [est.model_.centroids]
    step = ops.lloyd_step_plan(params=est.model_.params).block_map(cell)
    labels = lloyd._HostLabels(store.n, device)
    k, m = cell[0].shape
    zero = (torch.zeros((k, m), device=device), torch.zeros((k,), device=device),
            torch.zeros((), device=device))

    def combine(acc, out):
        return acc[0] + out[0], acc[1] + out[1], acc[2] + out[3]

    def one_pass():
        if devices is not None:
            shards = [store.shard(d, len(devices)) for d in range(len(devices))]
            accs = sharded.sharded_map_reduce(
                shards, [step] * len(devices), combine, [zero] * len(devices), devices=devices,
                emits=[lambda i, out, s=s: labels.put(s.row_offset(i), out[2]) for s in shards])
            return sharded.cross_device_sum(accs, devices)
        return engine.map_reduce(
            store, step, combine, zero,
            emit=lambda i, out: labels.put(store.row_offset(i), out[2]), device=device)

    one_pass()  # warm-up
    engine.reset_counters()
    _, prof = device_profile(one_pass)
    return dict(prefetch_stall_ms=engine.COUNTERS["prefetch_stall_s"] * 1e3, **prof)


def check_near_ties(what, Y, C, lab_a, lab_b, mismatch_share, tie_rtol):
    """Rows where two label vectors under the same centroids differ: at most
    ``mismatch_share`` of the rows, and each a near tie, its two centroids'
    f64 squared distances within ``tie_rtol`` * (|y|^2 + max |c|^2) of each
    other (the scale of the f32 roundoff in yy - 2 y.c + cc). Returns the
    rows and the largest relative gap."""
    n = Y.shape[0]
    rows = torch.nonzero(lab_a != lab_b).flatten()
    if rows.numel() > mismatch_share * n:
        raise AssertionError(f"{what}: {rows.numel()} of {n} labels differ")
    gap_rel = 0.0
    if rows.numel():
        y = Y[rows].double()
        C64 = C.double()
        d_a = (y - C64[lab_a[rows].long()]).square().sum(1)
        d_b = (y - C64[lab_b[rows].long()]).square().sum(1)
        scale = y.square().sum(1) + C64.square().sum(1).max()
        gap_rel = float(((d_a - d_b).abs() / scale).max())
        if gap_rel > tie_rtol:
            raise AssertionError(f"{what}: a label differs by more than a near tie ({gap_rel})")
    return rows, gap_rel


def check_assign_main_shape(Y, C, mismatch_share=1e-5, tie_rtol=1e-4) -> dict:
    """The assign kernel at the main path's shape (deep per-CTA row loops),
    gated; raises on any failure.

    * g equals the bincount of the kernel's own labels exactly;
    * Z equals the f64 sum of Y under the kernel's own labels within rtol
      1e-4 and atol 1e-4 * max|Z|, so near-tie rows do not mask its error;
    * labels that differ from the plain version's are at most
      ``mismatch_share`` of the rows (6 of 1,262,102 read on an H100), and
      each is a near tie: its two centroids' f64 squared distances differ by
      at most ``tie_rtol`` * (|y|^2 + max |c|^2), the scale of the f32
      roundoff in yy - 2 y.c + cc.

    Also reported: the step's cost against block_cost in f64.
    """
    from repro_torch.core.lloyd import block_cost
    from repro_torch.kernels import apnc_assign, ref

    n, k = Y.shape[0], C.shape[0]
    Z, g, lab, cost = apnc_assign.apnc_assign_step(Y, C, "l2")
    cost64 = float(block_cost(Y.double(), C.double(), "l2"))
    _, _, lr = ref.apnc_assign_ref(Y, C, "l2")
    lab_l = lab.long()
    if not torch.equal(g, torch.bincount(lab_l, minlength=k).float()):
        raise AssertionError("assign at the main shape: g is not the count of its labels")
    Z64 = torch.zeros((k, Y.shape[1]), dtype=torch.float64, device=Y.device)
    Z64.index_add_(0, lab_l, Y.double())
    z_err = check_close("assign Z at the main shape", Z.double(), Z64, 1e-4,
                        1e-4 * float(Z64.abs().max()))
    rows, gap_rel = check_near_ties("assign at the main shape", Y, C, lab, lr,
                                    mismatch_share, tie_rtol)
    return dict(n=n, k=k, m=Y.shape[1], g_equal_bincount=True, z_max_abs_err=z_err,
                z_abs_max=float(Z64.abs().max()), label_mismatches_vs_plain=int(rows.numel()),
                mismatch_max_rel_gap=gap_rel, cost=float(cost), cost_f64=cost64,
                cost_rel_err_vs_f64=abs(float(cost) - cost64) / cost64)


def reduce_share(run, event_ms=None) -> dict:
    """A traced pass of a fused step: the device time of its step kernel and
    of the (Z, g, cost) reduce kernel, and the reduce's share of the two;
    given the pass's event-timed ms, also the host's share of it (the part
    the two kernels do not cover: the card waits on the launches)."""
    _, prof = device_profile(run)
    top = prof["top_device_ms"]
    step_ms = sum(v for key, v in top.items() if "reduce_kernel" not in key)
    reduce_ms = sum(v for key, v in top.items() if "lloyd_reduce_kernel" in key)
    if not reduce_ms:
        return dict(step_ms="not measured", reduce_ms="not measured", reduce_share="not measured")
    out = dict(step_ms=step_ms, reduce_ms=reduce_ms, wall_ms=prof["wall_ms"],
               reduce_share=reduce_ms / (step_ms + reduce_ms))
    if event_ms is not None:
        out.update(event_ms=event_ms,
                   host_share_of_event_pass=max(0.0, 1.0 - (step_ms + reduce_ms) / event_ms))
    return out


def per_block(fn, X, bn):
    """A pass over the resident X in row blocks of bn, one call per block."""
    return lambda: [fn(X[i:i + bn]) for i in range(0, X.shape[0], bn)]


def multinomial_seed(generator, Y, k, disc):
    """The per-draw k-means++ loop ``kmeanspp_seed`` replaced: each draw
    copies the weights to the host and draws there with ``torch.multinomial``
    (one wait for the card a draw), the distances by the f32 GEMM expansion."""
    from repro_torch.core.apnc import pairwise_discrepancy

    first = int(torch.randint(0, Y.shape[0], (1,), generator=generator))
    C = torch.zeros((k, Y.shape[1]), dtype=Y.dtype, device=Y.device)
    C[0] = Y[first]
    mind = pairwise_discrepancy(Y, C[:1], disc)[:, 0]
    for i in range(1, k):
        w = (mind * mind).to(torch.float64).cpu()
        nxt = int(torch.multinomial(w / max(float(w.sum()), 1e-30), 1, generator=generator))
        C[i] = Y[nxt]
        mind = torch.minimum(mind, pairwise_discrepancy(Y, Y[nxt][None, :], disc)[:, 0])
    return C


def time_kmeanspp(pool, k) -> dict:
    """``kmeanspp_seed`` on the main path's pool shape, l2: one launch (the
    k - 1 picks), its plain version on the card from the same exponentials,
    the per-draw multinomial loop it replaced (library), a whole restart's
    seeding as the estimator runs it (exponentials drawn on the host, their
    copy, the launch and the flag's read), and the bound: k - 1 f64 distance
    passes over the pool, read once with the exponentials."""
    from repro_torch.core.lloyd import kmeanspp_init
    from repro_torch.kernels import kmeanspp, ref

    n, m = pool.shape
    E = torch.empty((k - 1, n), dtype=torch.float64).exponential_(
        1, generator=torch.Generator().manual_seed(29)).to(pool.device)
    t_ops = (k - 1) * (3.0 * n * m + 4.0 * n) / PEAK_F64_FLOPS
    t_bytes = (4.0 * n * m + 8.0 * (k - 1) * n + 4.0 * k * m + 8.0 * k) / PEAK_BYTES_PER_S
    return dict(
        n=n, m=m, k=k,
        ms=cuda_ms(lambda: kmeanspp.kmeanspp_seed(pool, E, 3, "l2"), 20),
        plain_ms=cuda_ms(lambda: ref.kmeanspp_seed_ref(pool, (E,), 3, k, "l2"), 5),
        library_ms=cuda_ms(lambda: multinomial_seed(torch.Generator().manual_seed(0), pool, k,
                                                    "l2"), 3, warmup=1),
        restart_ms=cuda_ms(lambda: kmeanspp_init(torch.Generator().manual_seed(0), pool, k,
                                                 "l2"), 5),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes")


def library_step(Yb, C):
    """The assign half of a Lloyd step in PyTorch calls: cdist -> argmin ->
    index_add_ + bincount + min-sum."""
    D = torch.cdist(Yb, C)
    lab = D.argmin(dim=1)
    Z = torch.zeros_like(C).index_add_(0, lab, Yb)
    return Z, torch.bincount(lab, minlength=C.shape[0]), lab, D.min(dim=1).values.sum()


def sdpa_backend(q, k, v, **kw) -> str:
    """The backend scaled_dot_product_attention picks for these inputs
    (causal), from PyTorch's own dispatcher, or "not determined"."""
    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "not determined"
    from torch.nn.attention import SDPBackend

    names = {int(v): k for k, v in SDPBackend.__members__.items()}
    try:
        return names.get(int(choose(q, k, v, is_causal=True, **kw)), "not determined")
    except (TypeError, RuntimeError):  # a dispatcher without the keyword
        return "not determined"


def time_flash(device, cfg) -> tuple[dict, list]:
    """flash_attention_bhsd at the serving path's prefill shape (B = 4,
    H = 16, S = 4,096, Dh = 64, f32, causal: B*H = 64), at llama3-8b's head
    shape (B*H = 32, Dh = 128) and at its grouped form (Hkv = 8): the kernel,
    its plain version and scaled_dot_product_attention on the same tensors in
    its (B, H, S, Dh) layout (contiguous copies made before timing;
    enable_gqa=True for the grouped heads), each against the bound. The
    bound counts 4 * Dh * S(S+1)/2 operations per query head (q k^T and p v
    over the causal pairs; the exp left out) at the f32 FMA rate, and q, k,
    v, o once each; the tensor-core bound counts the three TF32 products the
    kernel runs for each of those operations at the TF32 rate."""
    from repro_torch.kernels import flash_attention, ref

    rows = []
    S = cfg["lm_prompt"]
    for label, (B, H, Hkv, Dh) in (("serve prefill (qwen1.5-0.5b)", (cfg["lm_batch"], 16, 16, 64)),
                                   ("llama3-8b heads", (1, 32, 32, 128)),
                                   ("llama3-8b grouped heads", (1, 32, 8, 128))):
        g = torch.Generator(device=device).manual_seed(5)
        q = torch.randn((B, S, H, Dh), generator=g, device=device)
        k, v = (torch.randn((B, S, Hkv, Dh), generator=g, device=device) for _ in range(2))
        err = check_flash(f"flash_attention timing shape {label}", q, k, v, 0)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        kw = dict(enable_gqa=True) if Hkv != H else {}
        t_kernel = cuda_ms(lambda: flash_attention.flash_attention_bhsd(q, k, v), 10)
        t_plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, 0), 3, warmup=1)
        t_sdpa = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, **kw), 10)
        flops = 4.0 * Dh * (S * (S + 1) / 2) * B * H
        b_ms, b_by = bound(flops, 4.0 * (2 * B * S * H * Dh + 2 * B * S * Hkv * Dh))
        tc_ms = 3.0 * flops / PEAK_TF32_FLOPS * 1e3
        rows.append(dict(shape=dict(B=B, S=S, H=H, Hkv=Hkv, Dh=Dh, BH=B * H), label=label,
                         dtype="f32", causal=True, max_abs_err=err, ms=t_kernel, plain_ms=t_plain,
                         library_ms=t_sdpa,
                         library="scaled_dot_product_attention(is_causal=True"
                                 + (", enable_gqa=True)" if kw else ")"),
                         library_backend=sdpa_backend(qt, kt, vt, **kw), bound_ms=b_ms,
                         bound_by=b_by, tensor_core_bound_ms=tc_ms,
                         tensor_core_bound="3 TF32 products per f32 product at 495 TFLOP/s",
                         flops=flops, kernel_tflops=flops / t_kernel / 1e9,
                         roofline_share=b_ms / t_kernel,
                         tensor_core_roofline_share=tc_ms / t_kernel))
        del q, k, v, qt, kt, vt
    return rows[0], rows


def serve_timing(X, est, rff_est, mb) -> dict:
    """The three kernels of a serving flush, one ``mb``-row launch each at the
    served shapes (phase main's Nystrom model, phase rff's model): kernel,
    plain version, library call and bound, each launch event-timed over 200
    (a launch this small costs about its launch overhead), and the host time
    of one launch."""
    from repro_torch.kernels import apnc_assign, apnc_embed, ref, rff_embed

    p = est.model_.params
    L, R, kern = p.landmarks[0].contiguous(), p.R[0].contiguous(), p.kernel
    C = est.model_.centroids.contiguous()
    W = rff_est.model_.params.W.contiguous()
    scale = rff_est.model_.params.scale
    Xb = X[:mb].contiguous()
    d, l, m, k, mh = X.shape[1], L.shape[0], R.shape[0], C.shape[0], W.shape[1]
    Yb = apnc_embed.apnc_embed_block(Xb, L, R, kern)
    out = {}

    def one(name, run, plain, library, flops, nbytes, err):
        b, by = bound(flops, nbytes)
        out[name] = dict(rows=mb, ms=cuda_ms(run, 200, warmup=5),
                         plain_ms=cuda_ms(plain, 200, warmup=5), bound_ms=b, bound_by=by,
                         library_ms=cuda_ms(library, 200, warmup=5),
                         host_us_per_launch=host_us(run), max_abs_err=err)

    one("apnc_embed", lambda: apnc_embed.apnc_embed_block(Xb, L, R, kern),
        lambda: ref.apnc_embed_ref(Xb, L[None], R[None], kern),
        lambda: torch.exp(-kern.gamma * torch.cdist(Xb, L).square()) @ R.T,
        2.0 * mb * l * (d + m), 4.0 * (mb * d + l * d + m * l + mb * m),
        float((Yb - ref.apnc_embed_ref(Xb, L[None], R[None], kern)).abs().max()))
    one("rff_embed_block", lambda: rff_embed.rff_embed_block(Xb, W, scale),
        lambda: ref.rff_embed_ref(Xb, W, scale),
        lambda: (torch.cos(Xb @ W) * scale, torch.sin(Xb @ W) * scale),
        2.0 * mb * d * mh, 4.0 * (mb * d + d * mh + mb * 2 * mh),
        float((rff_embed.rff_embed_block(Xb, W, scale) - ref.rff_embed_ref(Xb, W, scale))
              .abs().max()))
    labels = apnc_assign.apnc_assign(Yb, C, "l2")[2]
    plain_labels = ref.apnc_assign_ref(Yb, C, "l2")[2]
    one("apnc_assign", lambda: apnc_assign.apnc_assign(Yb, C, "l2"),
        lambda: ref.apnc_assign_ref(Yb, C, "l2"),
        lambda: torch.cdist(Yb, C).argmin(dim=1),
        2.0 * mb * k * m, 4.0 * (mb * m + 2 * k * m + k + mb),
        float((labels != plain_labels).sum()))
    return out


def phase_timing(X, est, launches, stream_est, stream_launches, rff_est, rff_launches,
                 sweep_data, lm_launches, serve_launches, shard_launches, cfg
                 ) -> tuple[dict, list]:
    """Each kernel at the main path's shapes: kernel, plain version, library
    call chain, and the bound computed from this run's shapes. The Lloyd-step
    and RFF kernels are timed per pass over the resident X in the stream
    path's row blocks; fused_dequant_step per pass over the sweep's int8
    cache, its blocks resident on the card, at k = 164. The three kernels a
    serving flush launches are also timed at one flush's shape
    (``serve_timing``); their rows add phase serve's launches."""
    from repro_torch.kernels import apnc_assign, apnc_embed, lloyd_step, ref, rff_embed

    params = est.model_.params
    L, R, kern = params.landmarks[0].contiguous(), params.R[0].contiguous(), params.kernel
    n, d = X.shape
    l, m = L.shape[0], R.shape[0]
    C = est.model_.centroids.contiguous()
    k = C.shape[0]
    bn = cfg["block_rows"]

    Y = apnc_embed.apnc_embed_block(X, L, R, kern)
    Y_plain = ref.apnc_embed_ref(X, L[None], R[None], kern)
    embed_err = float((Y - Y_plain).abs().max())
    del Y_plain

    def embed_library():
        K = torch.exp(-kern.gamma * torch.cdist(X, L).square())
        return K @ R.T

    t_embed = cuda_ms(lambda: apnc_embed.apnc_embed_block(X, L, R, kern), 5)
    t_embed_plain = cuda_ms(lambda: ref.apnc_embed_ref(X, L[None], R[None], kern), 5)
    t_embed_lib = cuda_ms(embed_library, 5)
    # The sweep's embed-once use: one launch per 4,096-row block (32-row tiles).
    embed_blocks = dict(
        ms=cuda_ms(per_block(lambda xb: apnc_embed.apnc_embed_block(xb, L, R, kern), X, bn),
                   2, warmup=1),
        library_ms=cuda_ms(per_block(
            lambda xb: torch.exp(-kern.gamma * torch.cdist(xb, L).square()) @ R.T, X, bn),
            2, warmup=1))
    b_embed, by_embed = bound(2.0 * n * l * (d + m), 4.0 * (n * d + l * d + m * l + n * m))

    assign_check = check_assign_main_shape(Y, C)
    assign_err = assign_check["z_max_abs_err"]

    def assign_step(y):
        return apnc_assign.apnc_assign_step(y, C, "l2")

    t_assign = cuda_ms(lambda: assign_step(Y), 20)
    t_assign_plain = cuda_ms(lambda: ref.apnc_assign_step_ref(Y, C, "l2"), 20)
    t_assign_lib = cuda_ms(lambda: library_step(Y, C), 20)
    b_assign, by_assign = bound(2.0 * n * k * m, 4.0 * (n * m + 2 * k * m + k + n + 1))
    # Sweep (b)'s use: one launch per 4,096-row block of the f32 cache.
    t_assign_blocks = cuda_ms(per_block(assign_step, Y, bn), 3, warmup=1)
    assign_blocks = dict(
        ms=t_assign_blocks,
        library_ms=cuda_ms(per_block(lambda yb: library_step(yb, C), Y, bn), 3, warmup=1),
        kernel_vs_reduce=reduce_share(per_block(assign_step, Y, bn), t_assign_blocks),
        host_us_per_launch=host_us(lambda: assign_step(Y[:bn])))
    lloyd_profile = profile_lloyd(Y, k)
    seed_timing = time_kmeanspp(Y[:1024].contiguous(), k)
    y_abs_max = float(Y.abs().max())
    del Y

    # fused_apnc_step: the stream fit's params and final centroids.
    sp = stream_est.model_.params
    Ls, Rs, ks = sp.landmarks[0].contiguous(), sp.R[0].contiguous(), sp.kernel
    Cs = stream_est.model_.centroids.contiguous()
    fused_check = check_step(
        "fused_apnc_step on a main-path block",
        lambda: lloyd_step.fused_apnc_step(X[:bn], Ls, Rs, Cs, ks, "l2"),
        lambda: ref.fused_apnc_step_ref(X[:bn], Ls, Rs, Cs, ks, "l2"))

    def fused_library(xb):
        Yb = torch.exp(-ks.gamma * torch.cdist(xb, Ls).square()) @ Rs.T
        return library_step(Yb, Cs)

    t_fused = cuda_ms(per_block(lambda xb: lloyd_step.fused_apnc_step(xb, Ls, Rs, Cs, ks, "l2"),
                                X, bn), 2, warmup=1)
    t_fused_plain = cuda_ms(per_block(
        lambda xb: ref.fused_apnc_step_ref(xb, Ls, Rs, Cs, ks, "l2"), X, bn), 2, warmup=1)
    t_fused_lib = cuda_ms(per_block(fused_library, X, bn), 2, warmup=1)
    fused_split = reduce_share(per_block(
        lambda xb: lloyd_step.fused_apnc_step(xb, Ls, Rs, Cs, ks, "l2"), X, bn))
    b_fused, by_fused = bound(2.0 * n * l * (d + m) + 2.0 * n * k * m,
                              4.0 * (n * d + l * d + m * l + 2 * k * m + k + n + 1))

    # rff_embed_block and fused_rff_step: the rff stream fit's W and centroids.
    W = rff_est.model_.params.W.contiguous()
    mh, scale = W.shape[1], rff_est.model_.params.scale
    Cr = rff_est.model_.centroids.contiguous()
    rff_err = float((rff_embed.rff_embed_block(X[:bn], W, scale)
                     - ref.rff_embed_ref(X[:bn], W, scale)).abs().max())
    rff_tol = rff_tolerance(X[:bn], W, scale)
    if rff_err > rff_tol:
        raise AssertionError(f"rff_embed_block on a main-path block: {rff_err} > {rff_tol}")
    t_rff = cuda_ms(per_block(lambda xb: rff_embed.rff_embed_block(xb, W, scale), X, bn),
                    3, warmup=1)
    t_rff_plain = cuda_ms(per_block(lambda xb: ref.rff_embed_ref(xb, W, scale), X, bn),
                          3, warmup=1)

    def rff_library(xb):
        proj = xb @ W
        return torch.cos(proj) * scale, torch.sin(proj) * scale

    t_rff_lib = cuda_ms(per_block(rff_library, X, bn), 3, warmup=1)
    b_rff, by_rff = bound(2.0 * n * d * mh, 4.0 * (n * d + d * mh + n * 2 * mh))
    # The local rff fit's use: one launch over the whole X.
    rff_whole = dict(ms=cuda_ms(lambda: rff_embed.rff_embed_block(X, W, scale), 3, warmup=1),
                     library_ms=cuda_ms(lambda: rff_library(X), 3, warmup=1), bound_ms=b_rff)

    rff_check = check_step(
        "fused_rff_step on a main-path block",
        lambda: lloyd_step.fused_rff_step(X[:bn], W, Cr, scale, "l2"),
        lambda: ref.fused_rff_step_ref(X[:bn], W, Cr, scale, "l2"))

    def fused_rff_library(xb):
        proj = xb @ W
        return library_step(torch.cat([torch.cos(proj), torch.sin(proj)], dim=1) * scale, Cr)

    t_frff = cuda_ms(per_block(lambda xb: lloyd_step.fused_rff_step(xb, W, Cr, scale, "l2"),
                               X, bn), 3, warmup=1)
    t_frff_plain = cuda_ms(per_block(
        lambda xb: ref.fused_rff_step_ref(xb, W, Cr, scale, "l2"), X, bn), 3, warmup=1)
    t_frff_lib = cuda_ms(per_block(fused_rff_library, X, bn), 3, warmup=1)
    frff_split = reduce_share(per_block(
        lambda xb: lloyd_step.fused_rff_step(xb, W, Cr, scale, "l2"), X, bn), t_frff)
    b_frff, by_frff = bound(2.0 * n * d * mh + 2.0 * n * k * 2 * mh,
                            4.0 * (n * d + d * mh + 2 * k * 2 * mh + k + n + 1))

    # fused_dequant_step: the int8 cache's blocks, the f32 sweep's centroids.
    Cq = sweep_data["C"]
    encs = [to_device(sweep_data["q8"].get_encoded(i), X.device)
            for i in range(sweep_data["q8"].num_blocks)]
    dq_check = check_step(
        "fused_dequant_step on a main-path block",
        lambda: lloyd_step.fused_dequant_step(encs[0].payload, encs[0].scale, Cq, "l2"),
        lambda: ref.fused_dequant_step_ref(encs[0].payload, encs[0].scale, Cq, "l2"),
        cost_rtol=1e-4)
    t_dq = cuda_ms(lambda: [lloyd_step.fused_dequant_step(e.payload, e.scale, Cq, "l2")
                            for e in encs], 3, warmup=1)
    t_dq_plain = cuda_ms(lambda: [ref.fused_dequant_step_ref(e.payload, e.scale, Cq, "l2")
                                  for e in encs], 3, warmup=1)
    t_dq_lib = cuda_ms(lambda: [library_step(e.payload.float() * e.scale, Cq) for e in encs],
                       3, warmup=1)
    dq_split = reduce_share(
        lambda: [lloyd_step.fused_dequant_step(e.payload, e.scale, Cq, "l2") for e in encs], t_dq)
    dq_split["host_us_per_launch"] = host_us(
        lambda: lloyd_step.fused_dequant_step(encs[0].payload, encs[0].scale, Cq, "l2"))
    nb = len(encs)

    def dequant_bound(kk):
        return bound(2.0 * n * kk * m, 1.0 * n * m + 4.0 * (nb * m + 2 * kk * m + kk + n + 1))

    b_dq, by_dq = dequant_bound(k)
    del encs

    flash, flash_rows = time_flash(X.device, cfg)

    def row(name, source, replaces, launched, err, ms, plain_ms, bound_ms, bound_by, lib_ms):
        return dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=replaces, launches=launched, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=lib_ms)

    serve_rows = serve_timing(X, est, rff_est, cfg["serve"]["micro_batch"])
    rows = [
        row("apnc_embed", "apnc_embed.cu", "src/repro/kernels/apnc_embed.py:88",
            launches["apnc_embed"] + serve_launches["apnc_embed"], embed_err, t_embed,
            t_embed_plain, b_embed, by_embed, t_embed_lib),
        row("apnc_assign", "apnc_assign.cu", "src/repro/kernels/apnc_assign.py:91",
            launches["apnc_assign"] + serve_launches["apnc_assign"], assign_err, t_assign,
            t_assign_plain, b_assign, by_assign, t_assign_lib),
        row("fused_apnc_step", "lloyd_step.cu", "src/repro/kernels/lloyd_step.py:114",
            stream_launches["fused_apnc_step"], fused_check["z_max_abs_err"], t_fused,
            t_fused_plain, b_fused, by_fused, t_fused_lib),
        row("rff_embed_block", "rff_embed.cu", "src/repro/kernels/rff_embed.py:60",
            rff_launches["rff_embed_block"] + serve_launches["rff_embed_block"], rff_err,
            t_rff, t_rff_plain, b_rff, by_rff, t_rff_lib),
        row("fused_rff_step", "lloyd_step.cu", "src/repro/kernels/lloyd_step.py:268",
            rff_launches["fused_rff_step"], rff_check["z_max_abs_err"], t_frff,
            t_frff_plain, b_frff, by_frff, t_frff_lib),
        row("fused_dequant_step", "dequant_step.cu", "src/repro/kernels/lloyd_step.py:189",
            sweep_data["launches"], dq_check["z_max_abs_err"], t_dq, t_dq_plain, b_dq, by_dq,
            t_dq_lib),
        row("flash_attention_bhsd", "flash_attention.cu", "src/repro/kernels/flash_attention.py:85",
            lm_launches, flash["max_abs_err"], flash["ms"], flash["plain_ms"], flash["bound_ms"],
            flash["bound_by"], flash["library_ms"]),
        row("kmeanspp_seed", "kmeanspp_seed.cu", "src/repro/core/lloyd.py:74",
            launches["kmeanspp_seed"], 0.0, seed_timing["ms"], seed_timing["plain_ms"],
            seed_timing["bound_ms"], seed_timing["bound_by"], seed_timing["library_ms"]),
    ]
    for r in rows:  # phase shard's launches count with the main path's
        r["shard_launches"] = shard_launches.get(r["name"], 0)
        r["launches"] += r["shard_launches"]
    for r in rows:  # the serving flush's launches and one flush-shaped launch
        if r["name"] in serve_rows:
            r["serve_launches"] = serve_launches[r["name"]]
            r["serve_launch"] = serve_rows[r["name"]]
    info = dict(phase="timing", shapes=dict(n=n, d=d, l=l, m=m, k=k, block_rows=bn,
                                            rff_m_half=mh),
                timed_per="launch over the resident X (apnc_embed, apnc_assign with its "
                          "cost); pass over "
                          f"the resident X in {bn}-row blocks (the fused and RFF kernels); "
                          "pass over the int8 cache resident on the card at k = 164, one "
                          "candidate (fused_dequant_step); launch making a restart's k - 1 "
                          "picks on a 1,024-row pool of Y (kmeanspp_seed)",
                fused_dequant_bound_ms={str(kk): dequant_bound(kk)[0]
                                        for kk in cfg["sweep_k_grid"]},
                fused_dequant_sweep_s_per_candidate_pass=sweep_data["lloyd_s"]
                / max(sweep_data["candidate_passes"], 1),
                flash_attention=flash_rows,
                lloyd_profile=lloyd_profile,
                kmeanspp_seed=seed_timing,
                assign_main_shape=assign_check, fused_apnc_block=fused_check,
                apnc_assign_blocks_pass=assign_blocks,
                fused_rff_block=rff_check, fused_dequant_block=dq_check,
                rff_embed_whole_x_launch=rff_whole,
                fused_apnc_step_kernel_vs_reduce=fused_split,
                fused_rff_step_kernel_vs_reduce=frff_split,
                fused_dequant_step_kernel_vs_reduce=dq_split,
                redesigned_vs_previous={
                    "fused_apnc_step": dict(ms=t_fused, **PREVIOUS_MS["fused_apnc_step"]),
                    "rff_embed_block": dict(ms=t_rff, **PREVIOUS_MS["rff_embed_block"]),
                    "apnc_embed": dict(ms=t_embed, **PREVIOUS_MS["apnc_embed"]),
                    "flash_attention_bhsd": dict(ms=flash["ms"],
                                                 **PREVIOUS_MS["flash_attention_bhsd"]),
                    "fused_dequant_step": dict(ms=t_dq, **PREVIOUS_MS["fused_dequant_step"]),
                    "fused_rff_step": dict(ms=t_frff, **PREVIOUS_MS["fused_rff_step"]),
                    "apnc_assign": dict(ms=t_assign, **PREVIOUS_MS["apnc_assign"])},
                apnc_embed_blocks_pass=embed_blocks,
                rff_embed_atol=rff_tol,
                embed_max_rel_err=embed_err / y_abs_max,
                **{f"{r['name']}_roofline_share": r["bound_ms"] / r["ms"] for r in rows})
    return info, rows


# ------------------------------------------------------------------ driver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the path tiny on the CPU with the plain versions; "
                         "never prints the ok line")
    ap.add_argument("--n", type=int, default=None,
                    help="cut the main path's rows (default: the full ImageNet n)")
    args = ap.parse_args(argv)
    START[0] = time.perf_counter()

    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible (pass --cpu-rehearsal to "
              "rehearse on the CPU)", file=sys.stderr)
        return 2
    device = torch.device("cpu" if rehearsal else "cuda")
    if rehearsal:  # a smoke of the path, not a measurement: stay light beside other work
        torch.set_num_threads(1)
    cfg = dict(REHEARSAL if rehearsal else IMAGENET)
    if args.n:
        cfg["n"] = args.n

    if rehearsal:
        emit(dict(phase="device", device="cpu", rehearsal=True))
    else:
        smi = nvidia_smi()
        emit(dict(phase="device", kind=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count(), nvidia_smi=smi,
                  torch=torch.__version__, cuda=torch.version.cuda))
        emit(phase_build())

    t0 = time.perf_counter()
    X_all, y_all = make_blobs(cfg["n"] + 10_000 if not rehearsal else cfg["n"] + 500,
                              cfg["d"], cfg["k"], cfg["separation"], args.seed, device)
    n = cfg["n"]
    X, truth, Xq = X_all[:n], y_all[:n].cpu().numpy(), X_all[n:]
    sync(device)
    emit(dict(phase="data", n=n, held_out=Xq.shape[0], d=cfg["d"], k=cfg["k"],
              separation=cfg["separation"], seed=args.seed,
              seconds=time.perf_counter() - t0))

    emit(phase_parity(X, truth, device, cfg))
    main_info, est = phase_main(X, truth, Xq, cfg, device, args.seed)
    emit(main_info)
    emit(phase_agreement(X, truth, est, cfg, device,
                         rows=200_000 if not rehearsal else 2_000))

    t0 = time.perf_counter()
    store = pinned_store(X, cfg["block_rows"])
    emit(dict(phase="host_copy", bytes=X.numel() * 4, seconds=time.perf_counter() - t0,
              pinned=device.type == "cuda"))
    stream_info, stream_est = phase_stream(X, truth, Xq, store, est, cfg, device, args.seed)
    emit(stream_info)
    rff_info, rff_est = phase_rff(X, truth, store, cfg, device, args.seed)
    emit(rff_info)
    sweep_info, sweep_data = phase_sweep(X, truth, store, stream_est, cfg, device, args.seed)
    emit(sweep_info)
    shard_info = phase_shard(X, truth, store, est, stream_est, rff_est, sweep_data["a_result"],
                             cfg, device, args.seed)
    emit(shard_info)
    emit(phase_persist(X, truth, Xq, store, est, rff_est, stream_est, stream_info["per_pass_s"],
                       cfg, device, args.seed))
    emit(phase_baselines(cfg, device, args.seed))
    emit(phase_obs(X, store, est, stream_info["per_pass_s"], stream_est, cfg, device, args.seed))
    serve_info = phase_serve(Xq, est, rff_est, cfg, device, args.seed)
    emit(serve_info)
    examples_info = phase_examples(cfg, device)
    emit(examples_info)
    lm_info = phase_lm_serve(cfg, device, args.seed)
    emit(lm_info)
    background = start_dryrun_cells(cfg)
    try:
        train_info = phase_lm_train(cfg, device, args.seed)
        emit(train_info)
        ssm_info = phase_lm_ssm(cfg, device, args.seed)
        emit(ssm_info)
        ssm_train_info = phase_lm_ssm_train(cfg, device, args.seed)
        emit(ssm_train_info)
        mesh_info = phase_lm_mesh(cfg, device, args.seed)
        emit(mesh_info)
        mesh_ssm_info = phase_lm_mesh_ssm(cfg, device, args.seed)
        emit(mesh_ssm_info)
        emit(phase_dryrun(cfg, device, args.seed, background))
    finally:
        if background is not None:  # after a failure, the cells still running end first
            background[0].shutdown(cancel_futures=True)

    if rehearsal:
        emit(dict(phase="timing", skipped="cpu rehearsal: no device times"))
    else:
        info, rows = phase_timing(X, est, main_info["launches"], stream_est,
                                  stream_info["launches"], rff_est, rff_info["launches"],
                                  sweep_data, lm_info["flash_attention_launches"],
                                  serve_info["launches"], shard_info["launches"], cfg)
        emit(info)
        for r in rows:  # the examples' and the LM phases' launches count too
            if r["name"] in examples_info["launches"]:
                r["examples_launches"] = examples_info["launches"][r["name"]]
                r["launches"] += r["examples_launches"]
            if r["name"] == "flash_attention_bhsd":
                r["train_launches"] = train_info["flash_launches"]
                r["ssm_launches"] = ssm_info["flash_launches"]
                r["ssm_train_launches"] = ssm_train_info["flash_launches"]
                r["mesh_launches"] = mesh_info["flash_launches"]
                r["mesh_ssm_launches"] = mesh_ssm_info["flash_launches"]
                r["launches"] += (r["train_launches"] + r["ssm_launches"]
                                  + r["ssm_train_launches"] + r["mesh_launches"]
                                  + r["mesh_ssm_launches"])
                r["backward"] = [dict(shape=g["shape"], **{k: g[k] for k in (
                    "backward_ms", "plain_backward_ms", "sdpa_backward_ms", "backward_bound_ms",
                    "backward_bound_by")}) for g in train_info["b_attention_gradients"]]

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    if leaked:
        raise AssertionError(f"the port imported the JAX side: {leaked[:5]}")
    if rehearsal:
        emit(dict(phase="done", rehearsal=True))
        return 0
    emit(dict(kernels=rows))
    print(nvidia_smi(), flush=True)
    emit(dict(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
