"""The benchmark's work counts against the kernels' bounds at the ImageNet
shape (n 1,262,102, d 900, l 500, m 256, k 164) on the H100's float32 peak."""
import pytest

from bench import work

N, D, L, M, K = 1_262_102, 900, 500, 256, 164


@pytest.mark.parametrize("what, count, bound_ms", [
    ("embed of X", work.embed(N, D, L, M), 21.78),
    ("assign at k = 164", work.assign(N, M, K), 1.58),
    ("fused pass", work.fused_step(N, D, L, M, K), 23.36),
])
def test_bounds_at_the_imagenet_shape(what, count, bound_ms):
    assert count.bound_s("f32") * 1e3 == pytest.approx(bound_ms, abs=0.005), what


def test_a_fit_counts_its_passes():
    cfg = dict(n=N, d=D, l=L, m=M, k=K, seed_sample=1024)
    pool = work.embed(1024, D, L, M)
    local = work.fit(cfg, "local", 21)
    stream = work.fit(cfg, "stream", 21)
    assert local.flops == pytest.approx(pool.flops + work.embed(N, D, L, M).flops
                                        + 21 * work.assign(N, M, K).flops)
    assert stream.flops == pytest.approx(pool.flops + 21 * work.fused_step(N, D, L, M, K).flops)
    # a stream pass reads X again; a local pass reads only Y
    assert stream.bytes > local.bytes


def test_each_compute_peak_is_keyed_by_precision():
    assert work.PEAKS["flops_per_s"]["f32"] == 67e12
    assert work.PEAKS["bytes_per_s"] == 3.35e12
    # a memory-bound count is held to the bandwidth whatever the precision
    copy = work.Work(flops=0.0, bytes=3.35e9)
    assert copy.bound_s("bf16") == pytest.approx(1e-3)
