"""Where the time of the port's kernels goes, on one card, without a profiler.

    python3 tools/kernel_ablation.py                          # every target; needs a card and nvcc
    python3 tools/kernel_ablation.py --target apnc_embed      # one target (repeatable)

Where no ncu or nsys can run, this script takes a kernel apart instead: it
builds variants of a source under ``src/repro_torch/kernels/csrc`` side by
side (one nvcc each, all at once, under ``build/ablation/``), each with one
part removed or changed, and times each on the same inputs in one process.
A variant that removes work computes wrong numbers; only its time is read.
The variants that keep the arithmetic are checked (labels, bits or the
reference's tolerance). Six targets:

  * ``fused_apnc_step``: one 4,096-row block at the stream path's shape
    (d = 900, l = 500, m = 256, k = 164, rbf), the kernel plus its reduce,
    in us a launch; the base variant is also timed at other shapes (k = 1,
    the linear kernel, d = 1,800, l = 256, m = 512, d = 32), whose
    differences price one pipelined step of each phase and the epilogue.
  * ``apnc_embed``: one launch over the local fit's X (n = 1,262,102,
    d = 900, l = 500, m = 256, rbf), in ms; and a pass over X in the
    sweep's 4,096-row launches.
  * ``flash_attention``: the serving prefill (B = 4, S = 4,096, H = 16,
    Dh = 64, f32 and bf16), llama3-8b heads (H = 32, Dh = 128) and their
    grouped form (Hkv = 8), causal, in ms a launch.
  * ``fused_dequant_step``: one 4,096-row int8 block of the sweep's shape
    (m = 256, k = 164), the kernel plus its reduce, in us of device time a
    launch (torch.profiler: the host takes longer than the kernel to launch
    it); the base variant also at k = 82 and 128, which price the
    centroid groups of k = 164 (the k tail), and as bf16.
  * ``fused_rff_step``: one 4,096-row block of the rff stream fit's shape
    (d = 900, mh = 128, k = 164), likewise; the base variant also at k = 82
    and 128, at mh = 256 and at a ragged d = 902.
  * ``apnc_assign``: ``apnc_assign_step`` over the local fit's resident Y
    (n = 1,262,102, m = 256, k = 164), the kernel plus its reduce, in us of
    device time a launch; the base variant also at k = 82 and 128 and over
    one 4,096-row block (sweep (b)'s launch).

The embed mainloop is ``apnc_mainloop.cuh``, shared by the first two
targets, so its variants edit that header; the epilogue is
``lloyd_epilogue.cuh``, shared by the three fused steps and the assign
kernel. Every reading is
taken twice, in the variants' order and then in the reverse order, since a
reading moves with its place in the run. Prints one JSON object per
variant, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.kernels_fn import Kernel  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    apnc_assign,
    apnc_embed,
    build,
    flash_attention,
    lloyd_step,
    ref,
    rff_embed,
)

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ablation"
ML = "apnc_mainloop.cuh"
LS = "lloyd_step.cu"
AE = "apnc_embed.cu"
FA = "flash_attention.cu"
EP = "lloyd_epilogue.cuh"
DQ = "dequant_step.cu"
AS = "apnc_assign.cu"
_COPY_X = "    stage_block<G, VEC>(stage, X, n, d, G::BN, row0, w * G::BD);\n"
_COPY_L = "    stage_block<G, VEC>(stage + G::BN * G::SP, L, l, d, G::BL, j0, w * G::BD);\n"
_COPY_R = "    stage_block<G, VEC>(stage, R, m, l, G::MC, cc * G::MC, j0 + sub * G::RL);\n"
_WAIT = "  cpasync::wait<G::NS - 2>();\n  __syncthreads();\n  issue_step"
_NO_COPIES = [(ML, _COPY_X, ""), (ML, _COPY_L, ""), (ML, _COPY_R, "")]
# The epilogue's variants, shared by the fused_dequant_step and fused_rff_step
# targets. serial_norms: the row norms as one thread a row after the chunk's
# FMAs, the others waiting (the first port's serial spot), the same chains;
# per_row_z: a read-modify-write of the Z partial per row, not per label
# group, the same bits; z_unbatched, zb32: one or 32 Z loads in flight a
# thread, not 8, the same bits; no_prefetch: each C sub-chunk copied and waited for
# at its own step, nothing in flight, the same values; mk16: C sub-chunks of
# 16 columns, twice the steps and barriers, the same chains; kc256_tail:
# every centroid chunk's FMAs over all 256 centroids (k = 164 padded to 256,
# as before the tail was narrowed), the same values.
_EPILOGUE = {
    "serial_norms": [(EP, "        if (j0 == 0 && t < BN) {\n", "        if (false) {\n"),
                     (EP, "    if (!L1 && j0 == 0 && t < BN) s.yy_s[t] = yn;\n",
                      "    if (!L1 && j0 == 0 && t < BN) {\n      float v2 = 0.0f;\n"
                      "      for (int c = 0; c < m_pad; ++c) { const float v = ys[c * PAD + t]; "
                      "v2 = fmaf(v, v, v2); }\n      s.yy_s[t] = v2;\n    }\n")],
    "per_row_z": [(EP, "    for (int g0 = 0; g0 < ng; g0 += ZB) {\n      float v[ZB];\n"
                       "#pragma unroll\n      for (int u = 0; u < ZB; ++u)\n"
                       "        if (g0 + u < ng) v[u] = s.grp_fresh[g0 + u] ? 0.0f : "
                       "zp[(size_t)s.grp_lab[g0 + u] * m + c];\n"
                       "#pragma unroll\n      for (int u = 0; u < ZB; ++u) {\n"
                       "        if (g0 + u >= ng) break;\n"
                       "        for (unsigned rs = s.grp_rows[g0 + u]; rs; rs &= rs - 1u) "
                       "v[u] += yc[__ffs(rs) - 1];\n"
                       "        zp[(size_t)s.grp_lab[g0 + u] * m + c] = v[u];\n      }\n    }\n",
                   "    for (int gi = 0; gi < ng; ++gi) {\n"
                   "      volatile float* z = zp + (size_t)s.grp_lab[gi] * m + c;\n"
                   "      if (s.grp_fresh[gi]) *z = 0.0f;\n"
                   "      for (unsigned rs = s.grp_rows[gi]; rs; rs &= rs - 1u) "
                   "*z = *z + yc[__ffs(rs) - 1];\n    }\n")],
    "z_unbatched": [(EP, "constexpr int ZB = 8; ", "constexpr int ZB = 1; ")],
    "zb32": [(EP, "constexpr int ZB = 8; ", "constexpr int ZB = 32; ")],
    "no_prefetch": [(EP, "      if (c0 + MK < m_pad) issue_c(s.cs + ((step + 1) & 1) * CBUF, C, "
                         "k, m, j0, c0 + MK, vec);\n      else if (j0 + KC < k) issue_c(s.cs + "
                         "((step + 1) & 1) * CBUF, C, k, m, j0 + KC, 0, vec);\n", ""),
                    (EP, "      cpasync::wait<0>();\n      __syncthreads();  // sub-chunk `step` "
                         "landed; every thread is done with the other buffer\n",
                     "      __syncthreads();\n      if (step) issue_c(s.cs + (step & 1) * CBUF, C, k, m, "
                     "j0, c0, vec);\n      cpasync::wait<0>();\n      __syncthreads();\n")],
    "no_z_update": [(EP, "  const int ng = *s.n_grp;\n", "  const int ng = 0 * *s.n_grp;\n")],
    "mk16": [(EP, "constexpr int MK = 32; ", "constexpr int MK = 16; ")],
    "kc256_tail": [(EP, "    const int nq = (groups - half + 1) / 2;          // this warp's: "
                        "half, half + 2, ...\n", "    const int nq = 4;\n")],
}
_FLASH_NEXT = ("      load_kv<T, DP, VEC>(ring + ((j + 1 - j_lo) % NS) * TL::STAGE_BYTES, kb, vb, "
               "sk.s, sv.s,\n                          k0 + BK, S, Dh);\n")

#: target -> (source, variants). A variant is [(file, text, replacement)],
#: each text replaced everywhere it occurs (it must occur).
TARGETS = {
    "fused_apnc_step": (LS, {
        "base": [],
        "three_stages": [(ML, "static constexpr int NS = 2; ", "static constexpr int NS = 3; ")],
        "no_l_copy": [(ML, _COPY_L, "")],
        "no_copies": _NO_COPIES,
        "no_copies_no_barrier": [*_NO_COPIES, (ML, _WAIT, "  issue_step")],
        "no_s_fma": [(ML, "        fma_tile(acc, a, b);\n", "")],
        "no_y_fma": [(ML, "          fma_tile(y, a, b);\n", "")],
        "no_epilogue": [(LS, "    lloyd::assign_reduce_tile<L1>(sm.ys,",
                         "    if (k < 0) lloyd::assign_reduce_tile<L1>(sm.ys,")],
    }),
    "apnc_embed": (AE, {
        "base": [],
        "short_geometry": [(AE, "constexpr int TALL_WAVES = 4;", "constexpr int TALL_WAVES = 1 << 20;")],
        "tall_16x4": [(ML, "using Tall = Geometry<64, 8, 8, 32, 8>;",
                       "using Tall = Geometry<64, 4, 16, 64, 4>;")],
        "no_l_copy": [(ML, _COPY_L, "")],
        "no_copies": _NO_COPIES,
        "no_copies_no_barrier": [*_NO_COPIES, (ML, _WAIT, "  issue_step")],
        "no_s_fma": [(ML, "        fma_tile(acc, a, b);\n", "")],
        "no_y_fma": [(ML, "          fma_tile(y, a, b);\n", "")],
        "no_y_store": [(ML, "          if (vy && gc + 3 < m) {", "          if (ldy < 0) {")],
    }),
    "flash_attention": (FA, {
        "base": [],
        "bk64": [(FA, "static constexpr int BK = DP <= 64 && sizeof(T) == 2 ? 64 : 32;",
                  "static constexpr int BK = DP <= 64 ? 64 : 32;"),
                 (FA, "__launch_bounds__(THREADS, DP <= 64 ? 4 : 2)", "__launch_bounds__(THREADS)")],
        "no_register_cap": [(FA, "__launch_bounds__(THREADS, DP <= 64 ? 4 : 2)",
                             "__launch_bounds__(THREADS)")],
        "expf": [(FA, "scale * 1.4426950408889634f", "scale"), (FA, "exp2f(", "expf(")],
        "cvt_split": [(FA, "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
                           "  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;\n",
                       "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
                       "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo) : "
                       "\"f\"(x - __uint_as_float(hi)));\n")],
        "one_tf32_pass": [(FA, "    mma(c, alo, h0, h1);\n    mma(c, ahi, l0, l1);\n", "")],
        "no_pv": [(FA, "        mma3<false, TL::EXACT>(acc[nd], phi, plo, widen(vr[nd * 8]), "
                       "widen(vr[TL::VP + nd * 8]));\n", "        (void)vr;\n")],
        "no_next_tile_copies": [(FA, _FLASH_NEXT, "      cpasync::commit();\n")],
    }),
    "fused_dequant_step": (DQ, {
        "base": [],
        "plain_staging": [(DQ, "  const bool vec = (m * sizeof(T)) % 16 == 0 && ((size_t)Yq & 15) == 0;",
                           "  const bool vec = false;")],
        **_EPILOGUE,
        "no_decode": [(DQ, "    decode_tile<T>(ys, raw, scale_s, m_pad);",
                       "    if (m < 0) decode_tile<T>(ys, raw, scale_s, m_pad);")],
        "no_epilogue": [(DQ, "    lloyd::assign_reduce_tile<L1>(ys,",
                         "    if (k < 0) lloyd::assign_reduce_tile<L1>(ys,")],
    }),
    "apnc_assign": (AS, {
        "base": [],
        # the next tile's rows copied at the top of its own loop step, not
        # in flight during the epilogue's combine and Z update
        "no_y_prefetch": [
            (AS, "      if (tile + 1 < tile_hi) stage_tile<VEC>(raw, Y, n, m, m_pad, row0 + BN, "
                 "policy);\n", ""),
            (AS, "    cpasync::wait<0>();\n    __syncthreads();  // the tile's rows landed;",
             "    if (tile > tile_lo) stage_tile<VEC>(raw, Y, n, m, m_pad, row0, policy);\n"
             "    cpasync::wait<0>();\n    __syncthreads();  // the tile's rows landed;")],
        # Y's copies under L2's normal eviction, not evict-first
        "y_evict_normal": [("cp_async.cuh", "createpolicy.fractional.L2::evict_first.b64",
                            "createpolicy.fractional.L2::evict_normal.b64")],
        **_EPILOGUE,
        "no_cost": [(EP, "  if (t == 0)\n    for (int r = 0; r < rows; ++r) "
                         "cost_acc += s.mind_s[r];\n", "")],
        # each C (centroid) or Y operand of the distance loop read once a
        # sub-chunk instead of once every 4 columns: the price of each stream
        # of shared-memory reads
        "hoisted_c_reads": [(EP, "(cb + (lane + 32 * (half + 2 * q)) * CP + c);",
                             "(cb + (lane + 32 * (half + 2 * q)) * CP);")],
        "hoisted_y_reads": [(EP, "(ys + (c0 + c + cc) * PAD + RI * ty);",
                             "(ys + (c0 + cc) * PAD + RI * ty);"),
                            (EP, "(ys + (c0 + c + cc) * PAD + RI * ty + 4);",
                             "(ys + (c0 + cc) * PAD + RI * ty + 4);")],
        # the centroid norms summed again in every tile, not kept from the
        # CTA's first; the distance loop over C fully unrolled (8 steps of 4
        # columns a sub-chunk, not 2 at a time)
        "norms_every_tile": [(EP, "  const bool cc_kept = !first && k <= KC;",
                              "  const bool cc_kept = false;")],
        "c_unroll_full": [(EP, "#pragma unroll 2\n  for (int c = 0; c < MK; c += 4) {\n"
                               "    float4 b[NQ], a[8];",
                           "#pragma unroll\n  for (int c = 0; c < MK; c += 4) {\n"
                           "    float4 b[NQ], a[8];")],
        "one_cta_per_sm": [(AS, "__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)"),
                           (AS, "    *smem = tiled_smem_bytes(m);\n", "    *smem = SMEM_MAX;\n")],
        "no_epilogue": [(AS, "    lloyd::assign_reduce_tile<L1>(ys,",
                         "    if (k < 0) lloyd::assign_reduce_tile<L1>(ys,")],
    }),
    "fused_rff_step": (LS, {
        "base": [],
        "copy4": [(LS, "  const bool vec = d % 4 == 0 && mh % 4 == 0 && aligned16(X) && aligned16(W);",
                   "  const bool vec = false;")],
        **_EPILOGUE,
        "no_embed": [(LS, "rffml::project<G, VEC>(acc, X, W, n, d, mh,",
                      "rffml::project<G, VEC>(acc, X, W, n, 0, mh,")],
        "no_trig": [(LS, "for (int i = 0; i < 4; ++i) sincosf(acc[i][jj], &sv[i], &cv[i]);",
                     "for (int i = 0; i < 4; ++i) { sv[i] = acc[i][jj]; cv[i] = acc[i][jj]; }")],
        "no_epilogue": [(LS, "    lloyd::assign_reduce_tile<L1>(ys,",
                         "    if (k < 0) lloyd::assign_reduce_tile<L1>(ys,")],
    }),
}
#: Variants that keep the kernel's arithmetic (checked), per target.
EXACT = {"fused_apnc_step": ("base", "three_stages"),
         "apnc_embed": ("base", "short_geometry", "tall_16x4"),
         "flash_attention": ("base", "bk64", "no_register_cap", "expf", "cvt_split"),
         "fused_dequant_step": ("base", "plain_staging", "serial_norms", "per_row_z",
                                "no_prefetch", "mk16", "kc256_tail", "z_unbatched", "zb32"),
         "fused_rff_step": ("base", "copy4", "serial_norms", "per_row_z", "no_prefetch", "mk16",
                            "kc256_tail", "z_unbatched", "zb32"),
         "apnc_assign": ("base", "no_y_prefetch", "y_evict_normal", "serial_norms", "per_row_z",
                         "no_prefetch", "mk16", "kc256_tail", "z_unbatched", "zb32",
                         "norms_every_tile", "c_unroll_full", "one_cta_per_sm")}


def build_variants(targets) -> dict[tuple[str, str], Path]:
    procs = {}
    for target in targets:
        source, variants = TARGETS[target]
        for name, edits in variants.items():
            src = OUT / target / name
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(CSRC, src)
            for file, text, repl in edits:
                body = (src / file).read_text()
                if text not in body:
                    raise RuntimeError(f"{target} variant {name}: {text!r} is not in {file}")
                (src / file).write_text(body.replace(text, repl))
            so = src / f"{Path(source).stem}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src / source)]
            procs[target, name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{out}")
        libs[key] = so
    return libs


def cuda_time(fn, iters, warmup=2) -> float:
    """ms a call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, reps=40) -> float:
    """us of device time a call: the kernels' own time under torch.profiler
    over ``reps`` calls (a call launches faster on the card than the host
    issues it, so an event-timed loop would read the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "self_device_time_total", 0) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA)
    return total / reps


def use(lib_name: str, so: Path) -> None:
    build._LIBS[lib_name] = ctypes.CDLL(str(so))


def both_orders(names, read) -> dict[str, list]:
    """read(name) for every variant, in order and then in reverse order."""
    got = {name: [] for name in names}
    for name in [*names, *reversed(names)]:
        got[name].append(read(name))
    return got


def ablate_fused(libs, dev) -> list[dict]:
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((4096 * 2, 1800), device=dev, generator=g) * 900 ** -0.5

    def case(d, l, m, k, kern=Kernel("rbf", gamma=0.5)):
        xb, L = X[:4096, :d].contiguous(), X[-l:, :d].contiguous()
        R = torch.randn((m, l), device=dev, generator=g) * l ** -0.5
        Y = apnc_embed.apnc_embed_block(xb, L, R, kern)
        return xb, L, R, Y[:k].contiguous(), kern, Y

    shapes = {"main": case(900, 500, 256, 164), "k1": case(900, 500, 256, 1),
              "linear": case(900, 500, 256, 164, Kernel("linear")),
              "d1800": case(1800, 500, 256, 164), "l256": case(900, 256, 256, 164),
              "m512": case(900, 500, 512, 164), "d32": case(32, 500, 256, 164)}

    def run(sname):
        xb, L, R, C, kern, _ = shapes[sname]
        return lambda: lloyd_step.fused_apnc_step(xb, L, R, C, kern, "l2")

    names = [n for t, n in libs if t == "fused_apnc_step"]
    use("lloyd_step", libs["fused_apnc_step", "base"])
    cuda_time(run("main"), 2000)  # bring the card to its working clock

    def read(name):
        use("lloyd_step", libs["fused_apnc_step", name])
        return cuda_time(run("main"), 40, 3) * 1e3

    main_us = both_orders(names, read)
    rows = []
    for name in names:
        use("lloyd_step", libs["fused_apnc_step", name])
        row = dict(target="fused_apnc_step", variant=name, main_us=main_us[name])
        if name in EXACT["fused_apnc_step"]:
            xb, L, R, C, kern, Y = shapes["main"]
            labels = lloyd_step.fused_apnc_step(xb, L, R, C, kern, "l2")[2]
            row["labels_equal_unfused"] = bool(
                torch.equal(labels, apnc_assign.apnc_assign(Y, C, "l2")[2]))
        if name == "base":
            for sname in shapes:
                if sname != "main":
                    row[f"{sname}_us"] = cuda_time(run(sname), 40, 3) * 1e3
        rows.append(row)
    return rows


def ablate_embed(libs, dev) -> list[dict]:
    n, d, l, m = 1_262_102, 900, 500, 256
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((n, d), device=dev, generator=g) * d ** -0.5
    L = X[-l:].contiguous()
    R = torch.randn((m, l), device=dev, generator=g) * l ** -0.5
    kern = Kernel("rbf", gamma=0.5)
    names = [nm for t, nm in libs if t == "apnc_embed"]

    def whole():
        return apnc_embed.apnc_embed_block(X, L, R, kern)

    def blocks():
        return [apnc_embed.apnc_embed_block(X[i:i + 4096], L, R, kern) for i in range(0, n, 4096)]

    use("apnc_embed", libs["apnc_embed", "base"])
    want = whole()
    cuda_time(whole, 10)

    def read(name):
        use("apnc_embed", libs["apnc_embed", name])
        return cuda_time(whole, 3, 1)

    whole_ms = both_orders(names, read)
    rows = []
    for name in names:
        use("apnc_embed", libs["apnc_embed", name])
        row = dict(target="apnc_embed", variant=name, whole_x_ms=whole_ms[name],
                   tile_rows=apnc_embed.tile_rows(n, m))
        if name in EXACT["apnc_embed"]:
            row["bits_equal_base"] = bool(torch.equal(whole(), want))
            row["blocks_pass_ms"] = cuda_time(blocks, 2, 1)
        rows.append(row)
    return rows


def ablate_flash(libs, dev) -> list[dict]:
    g = torch.Generator(device=dev).manual_seed(5)
    shapes = {"serve_f32": (4, 4096, 16, 16, 64, torch.float32),
              "serve_bf16": (4, 4096, 16, 16, 64, torch.bfloat16),
              "d128_f32": (1, 4096, 32, 32, 128, torch.float32),
              "gqa_f32": (1, 4096, 32, 8, 128, torch.float32)}
    inputs = {}
    for sname, (B, S, H, Hkv, Dh, dt) in shapes.items():
        inputs[sname] = tuple(torch.randn(shape, device=dev, generator=g).to(dt) for shape in
                              ((B, S, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))
    names = [nm for t, nm in libs if t == "flash_attention"]

    def run(sname):
        q, k, v = inputs[sname]
        return lambda: flash_attention.flash_attention_bhsd(q, k, v)

    use("flash_attention", libs["flash_attention", "base"])
    cuda_time(run("serve_f32"), 200)
    readings = {}
    for sname in shapes:
        def read(name, sname=sname):
            use("flash_attention", libs["flash_attention", name])
            return cuda_time(run(sname), 10, 2)

        readings[sname] = both_orders(names, read)
    rows = []
    for name in names:
        use("flash_attention", libs["flash_attention", name])
        row = dict(target="flash_attention", variant=name,
                   **{f"{s}_ms": readings[s][name] for s in shapes})
        if name in EXACT["flash_attention"]:
            errs = {}
            for sname, (q, k, v) in inputs.items():
                got = flash_attention.flash_attention_bhsd(q, k, v).float()
                want = ref.flash_attention_ref(q[:, :1024], k[:, :1024], v[:, :1024]).float()
                errs[sname] = float((got[:, :1024] - want).abs().max())
            row["max_abs_err_first_1024_rows"] = errs
        rows.append(row)
    return rows


def ablate_step(target, lib_name, shapes, run, libs) -> list[dict]:
    """One fused step's variants on shapes["main"] (device us a launch, both
    orders), the exact ones checked bitwise against base on every output,
    and base alone at the other shapes."""
    names = [nm for t, nm in libs if t == target]
    use(lib_name, libs[target, "base"])
    want = run("main")()
    for _ in range(200):  # bring the card to its working clock
        run("main")()

    def read(name):
        use(lib_name, libs[target, name])
        return device_us(run("main"))

    main_us = both_orders(names, read)
    rows = []
    for name in names:
        use(lib_name, libs[target, name])
        row = dict(target=target, variant=name, main_device_us=main_us[name])
        if name in EXACT[target]:
            got = run("main")()
            row["bits_equal_base"] = all(torch.equal(a, b) for a, b in zip(got, want))
        if name == "base":
            for sname in shapes:
                if sname != "main":
                    row[f"{sname}_device_us"] = device_us(run(sname))
            row["main_event_us"] = cuda_time(run("main"), 200, 3) * 1e3
        rows.append(row)
    return rows


def ablate_dequant(libs, dev) -> list[dict]:
    g = torch.Generator(device=dev).manual_seed(0)
    m = 256
    Y = torch.randn((4096 + 164, m), device=dev, generator=g) * m ** -0.5
    scale = (Y.abs().amax(0, keepdim=True) / 127).clamp(min=1e-12)
    q = torch.round(Y / scale).clamp(-127, 127).to(torch.int8)
    C = ref.dequant_ref(q[4096:], scale)
    one = torch.ones((), device=dev)
    shapes = {"main": (q[:4096], scale, C), "k82": (q[:4096], scale, C[:82].contiguous()),
              "k128": (q[:4096], scale, C[:128].contiguous()),
              "bf16": (Y[:4096].to(torch.bfloat16), one, C)}

    def run(sname):
        yq, sc, cc = shapes[sname]
        return lambda: lloyd_step.fused_dequant_step(yq, sc, cc, "l2")

    return ablate_step("fused_dequant_step", "dequant_step", shapes, run, libs)


def ablate_rff(libs, dev) -> list[dict]:
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((4096, 902), device=dev, generator=g) * 900 ** -0.5
    W = torch.randn((902, 256), device=dev, generator=g) * 0.5

    def case(d, mh, k):
        xb, w = X[:, :d].contiguous(), W[:d, :mh].contiguous()
        scale = mh ** -0.5
        return xb, w, rff_embed.rff_embed_block(xb[-k:], w, scale).contiguous(), scale

    shapes = {"main": case(900, 128, 164), "k82": case(900, 128, 82),
              "k128": case(900, 128, 128), "mh256": case(900, 256, 164),
              "d902": case(902, 128, 164)}

    def run(sname):
        xb, w, cc, scale = shapes[sname]
        return lambda: lloyd_step.fused_rff_step(xb, w, cc, scale, "l2")

    return ablate_step("fused_rff_step", "lloyd_step", shapes, run, libs)


def ablate_assign(libs, dev) -> list[dict]:
    g = torch.Generator(device=dev).manual_seed(0)
    n, m = 1_262_102, 256
    Y = torch.randn((n, m), device=dev, generator=g) * m ** -0.5
    C = Y[-164:].contiguous()
    shapes = {"main": (Y, C), "k82": (Y, C[:82].contiguous()), "k128": (Y, C[:128].contiguous()),
              "block": (Y[:4096], C)}

    def run(sname):
        y, c = shapes[sname]
        return lambda: apnc_assign.apnc_assign_step(y, c, "l2")

    return ablate_step("apnc_assign", "apnc_assign", shapes, run, libs)


ABLATE = {"fused_apnc_step": ablate_fused, "apnc_embed": ablate_embed,
          "flash_attention": ablate_flash, "fused_dequant_step": ablate_dequant,
          "fused_rff_step": ablate_rff, "apnc_assign": ablate_assign}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", action="append", choices=sorted(TARGETS),
                    help="a target to take apart (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    targets = args.target or list(TARGETS)
    libs = build_variants(targets)
    build.build_all(("apnc_embed", "apnc_assign", "lloyd_step", "flash_attention", "rff_embed",
                     "dequant_step"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for target in targets:
        for row in ABLATE[target](libs, dev):
            print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "nvidia-smi: not read")
    return 0


if __name__ == "__main__":
    sys.exit(main())
