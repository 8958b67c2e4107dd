"""The port's roofline arithmetic (repro_torch.roofline.analysis) against the
JAX package's, under the H100 SXM5's peaks in place of the TPU's.

The counts (flops, bytes, parameters, model flops) must equal the JAX
package's for every config; only the peaks differ, and no TPU constant may
appear anywhere in the port.
"""
import json
import re
from pathlib import Path

import pytest

from repro.configs import ALL_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.roofline import analysis as ja
from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES
from repro_torch.roofline import analysis as ta

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def test_constants_are_the_h100_sxm5s():
    assert ta.PEAK_FLOPS == 67e12 and ta.HBM_BW == 3.35e12
    assert ta.NVLINK_BW == 25e9 and ta.NVLINK_LINKS == 18
    assert ta.PEAK_BF16_FLOPS == 989e12


def test_roofline_terms_math():
    terms = ta.roofline_terms(flops=67e12, bytes_hbm=3.35e12, collective_bytes=25e9, chips=1)
    assert terms["t_compute_s"] == pytest.approx(1.0)
    assert terms["t_memory_s"] == pytest.approx(1.0)
    assert terms["t_collective_s"] == pytest.approx(1.0)
    assert terms["bottleneck"] in ("compute", "memory", "collective")
    two = ta.roofline_terms(flops=67e12, bytes_hbm=0, collective_bytes=18 * 25e9, chips=2,
                            links=18)
    assert two["t_compute_s"] == pytest.approx(0.5) and two["t_collective_s"] == pytest.approx(0.5)
    bf16 = ta.roofline_terms(flops=989e12, bytes_hbm=0, collective_bytes=0,
                             peak_flops=ta.PEAK_BF16_FLOPS)
    assert bf16["t_compute_s"] == pytest.approx(1.0)


def test_roofline_bottleneck_selection():
    t = ta.roofline_terms(flops=1e15, bytes_hbm=1e6, collective_bytes=0, chips=1)
    assert t["bottleneck"] == "compute" and t["roofline_fraction"] == 1.0
    t = ta.roofline_terms(flops=1e6, bytes_hbm=1e13, collective_bytes=0, chips=1)
    assert t["bottleneck"] == "memory"
    t = ta.roofline_terms(flops=1e6, bytes_hbm=1e6, collective_bytes=1e12, chips=1)
    assert t["bottleneck"] == "collective"


@pytest.mark.parametrize("shape", [(4096, 900, 500, 256, 164), (1_262_102, 900, 500, 256, 164),
                                   (1000, 12, 64, 32, 5)])
@pytest.mark.parametrize("fused", [True, False])
def test_lloyd_step_record_is_the_references(shape, fused):
    n, d, l, m, k = shape
    kw = dict(n=n, d=d, l=l, m=m, k=k, fused=fused)
    assert ta.lloyd_step_record(**kw) == ja.lloyd_step_record(**kw)


def test_the_two_counts_of_a_lloyd_step():
    """`lloyd_step_record` counts 2ndl + 2nlm + 4nmk (the one-hot Z product as
    a matmul); PERF.md's bound column counts 2nmk for the distances only. At
    the ImageNet pass (n = 1,262,102) the two read 24.9 and 23.36 ms at the
    f32 peak."""
    n, d, l, m, k = 1_262_102, 900, 500, 256, 164
    rec = ta.lloyd_step_record(n=n, d=d, l=l, m=m, k=k)
    assert rec["flops"] / ta.PEAK_FLOPS == pytest.approx(24.94e-3, rel=1e-3)
    bound_column = 2.0 * n * d * l + 2.0 * n * l * m + 2.0 * n * m * k
    assert bound_column / ta.PEAK_FLOPS == pytest.approx(23.36e-3, rel=1e-3)
    assert rec["flops"] - bound_column == 2.0 * n * m * k


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_and_model_flops_are_the_references(arch):
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    assert ta.param_counts(cfg) == ja.param_counts(jcfg)
    for shape in SHAPES:
        assert ta.model_flops(cfg, shape) == ja.model_flops(jcfg, shape)


def test_analyze_record_counts_are_the_references():
    rec = {"arch": "llama3-8b", "shape": "prefill_32k", "flops": 3e15, "bytes": 9e12,
           "hbm_bytes": 4e12, "collective_bytes": 2e11, "mesh": {"data": 2, "model": 4}}
    got = ta.analyze_record(rec, get_arch("llama3-8b"))
    want = ja.analyze_record(rec, j_get_arch("llama3-8b"))
    for key in ("model_flops_global", "hlo_flops_global", "useful_ratio", "flops", "mesh"):
        assert got[key] == want[key], key
    assert got["t_compute_s"] == pytest.approx(3e15 / 989e12)
    assert got["t_memory_s"] == pytest.approx(4e12 / 3.35e12)
    assert got["t_collective_s"] == pytest.approx(2e11 / (18 * 25e9))


def test_load_results_is_the_references(tmp_path):
    path = tmp_path / "dry.jsonl"
    recs = [{"arch": "a", "shape": "s", "flops": 1}, {"arch": "a", "shape": "s", "flops": 2},
            {"arch": "b", "shape": "s", "opts": ["x"], "flops": 3}]
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n\n")
    assert ta.load_results(path) == ja.load_results(path)
    assert [r["flops"] for r in ta.load_results(path)] == [2, 3]
    assert ta.load_results(tmp_path / "missing.jsonl") == []


def test_no_tpu_constant_in_the_port():
    """The v5e's peaks (197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s ICI) are a
    TPU's and must not be the port's."""
    pattern = re.compile(r"197e12|197e\+12|819e9|819e\+9|ICI_BW|50e9")
    hits = [f"{p.relative_to(PORT)}:{i}" for p in PORT.rglob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1) if pattern.search(line)]
    assert not hits, hits
