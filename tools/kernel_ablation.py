"""Where the time of the port's fused_apnc_step goes, on one card, without a profiler.

    python3 tools/kernel_ablation.py            # needs a CUDA card and nvcc

Where no ncu or nsys can run, this script takes the kernel apart instead: it
builds variants of
``src/repro_torch/kernels/csrc/lloyd_step.cu`` side by side (one nvcc each,
all at once, under ``build/ablation/``), each with one part removed or
changed, and times each on the same inputs in one process: one 4,096-row
block at the stream path's shape (d = 900, l = 500, m = 256, k = 164, rbf),
the kernel plus its reduce, per launch. A variant that removes work computes
wrong numbers; only its time is read. The base variant is also timed at
other shapes (k = 1, the linear kernel, d = 1,800, l = 256, m = 512, d = 32),
whose differences price one pipelined step of each phase and the epilogue.

The main shape is timed twice for every variant, in order and in reverse
order, since a reading moves by several us with its place in the run. Prints
one JSON object per variant, then the card's name and power limit.
"""
from __future__ import annotations

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
from repro_torch.kernels import apnc_assign, apnc_embed, build, lloyd_step  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ablation"
LS = "lloyd_step.cu"
_COPY_X = "    stage_block<VEC>(stage, X, n, d, BN, row0, w * BD);\n"
_COPY_L = "    stage_block<VEC>(stage + BN * SP, L, l, d, BL, j0, w * BD);\n"
_COPY_R = "    stage_block<VEC>(stage, R, m, l, MC, cc * MC, j0 + sub * RL);\n"
_WAIT = "  cpasync::wait<NS - 2>();\n  __syncthreads();\n  issue_step"
#: The variants that keep the kernel's arithmetic (their labels are checked).
EXACT = ("base", "three_stages")
#: name -> [(file, text, replacement)], each text replaced once.
VARIANTS = {
    "base": [],
    "three_stages": [(LS, "constexpr int NS = 2;", "constexpr int NS = 3;")],
    "no_l_copy": [(LS, _COPY_L, "")],
    "no_copies": [(LS, _COPY_X, ""), (LS, _COPY_L, ""), (LS, _COPY_R, "")],
    "no_copies_no_barrier": [(LS, _COPY_X, ""), (LS, _COPY_L, ""), (LS, _COPY_R, ""),
                             (LS, _WAIT, "  issue_step")],
    "no_s_fma": [(LS, "          fma_8x4x4(acc, a, b);\n", "")],
    "no_y_fma": [(LS, "            fma_8x4x4(y, a, b);\n", "")],
    "no_epilogue": [(LS, "    lloyd::assign_reduce_tile<L1, BN, YP, true>(",
                     "    if (k < 0) lloyd::assign_reduce_tile<L1, BN, YP, true>(")],
}


def build_variants() -> dict[str, Path]:
    procs = {}
    for name, edits in VARIANTS.items():
        src = OUT / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(CSRC, src)
        for file, text, repl in edits:
            body = (src / file).read_text()
            if text not in body:
                raise RuntimeError(f"variant {name}: {text!r} is not in {file}")
            (src / file).write_text(body.replace(text, repl, 1))
        so = src / "lloyd_step.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src / LS)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        libs[name] = so
    return libs


def cuda_us(fn, iters=40, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    libs = build_variants()
    build.build_all(("apnc_embed", "apnc_assign"))
    dev = torch.device("cuda")
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
    # Bring the card to its working clock before the first timing.
    build._LIBS["lloyd_step"] = ctypes.CDLL(str(libs["base"]))
    xb, L, R, C, kern, _ = shapes["main"]
    cuda_us(lambda: lloyd_step.fused_apnc_step(xb, L, R, C, kern, "l2"), iters=2000)
    # The main shape is timed twice, in the variants' order and then in the
    # reverse order: a reading depends on its place in the run by several us.
    main_us = {name: [] for name in libs}
    for name in [*libs, *reversed(libs)]:
        build._LIBS["lloyd_step"] = ctypes.CDLL(str(libs[name]))
        xb, L, R, C, kern, _ = shapes["main"]
        main_us[name].append(cuda_us(lambda: lloyd_step.fused_apnc_step(xb, L, R, C, kern, "l2")))
    for name, so in libs.items():
        build._LIBS["lloyd_step"] = ctypes.CDLL(str(so))
        xb, L, R, C, kern, Y = shapes["main"]
        labels = lloyd_step.fused_apnc_step(xb, L, R, C, kern, "l2")[2]
        row = dict(variant=name, main_us=main_us[name])
        if name in EXACT:  # the others compute wrong labels by design
            row["labels_equal_unfused"] = bool(
                torch.equal(labels, apnc_assign.apnc_assign(Y, C, "l2")[2]))
        if name == "base":
            for sname, (xb, L, R, C, kern, _) in shapes.items():
                if sname != "main":
                    row[f"{sname}_us"] = cuda_us(
                        lambda: lloyd_step.fused_apnc_step(xb, L, R, C, kern, "l2"))
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "nvidia-smi: not read")
    return 0


if __name__ == "__main__":
    sys.exit(main())
