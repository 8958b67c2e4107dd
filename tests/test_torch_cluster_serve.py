"""The port's serving CLI (`repro_torch.launch.cluster_serve`) on the CPU:
the port of tests/test_stream.py::test_cluster_serve_cli_matches_predict,
the open-loop mode with a hot swap, the sweep-selected model, a checkpoint
written by the JAX package served with the reference's labels, and the
sharded backend (``--backend stream_shard``) fitting and serving."""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest

from repro.api import KernelKMeans as JKernelKMeans
from repro.core.kkmeans import predict as j_predict
from repro.data.synthetic import gaussian_blobs_blocks as j_blocks
from repro.distributed import checkpoint as jck
from repro_torch.api import KernelKMeans
from repro_torch.launch import cluster_serve
from repro_torch.serving import ServingTier

SMALL = ["--micro-batch", "64", "--n-fit", "2000", "--block-rows", "512", "--d", "8",
         "--k", "3", "--l", "48", "--m", "32", "--iters", "8", "--device", "cpu",
         "--stats-every", "0"]


def test_cluster_serve_cli_matches_predict():
    """Micro-batched serving agrees exactly with core.kkmeans.predict on the
    replayed request log (the CLI raises SystemExit(1) on any mismatch)."""
    stats = cluster_serve.main(["--requests", "600", *SMALL])
    assert stats["mismatches"] == 0 and stats["served"] == 600
    assert stats["p99_ms"] >= stats["p50_ms"] > 0
    assert stats["metrics"]["serve.admitted"] == 600
    assert stats["metrics"]["serve.batch_size"]["max"] <= 64


def _fit_rows():
    """Rows of the mixture the CLI draws its request log from (seed 0 + 7919),
    so that the served labels spread over the clusters."""
    return j_blocks(7919, 1500, 8, 3, block_rows=1500, separation=4.0)[0].get(0)


def _save_port_model(path, method, seed):
    X = _fit_rows()
    kw = dict(method=method, m=16) if method == "rff" else dict(method=method, l=48, m=32)
    est = KernelKMeans(3, kernel="rbf", kernel_params={"gamma": 1.0 / 8}, iters=8,
                       device="cpu", **kw)
    est.fit(X, seed=seed)
    est.save(path)


def test_open_loop_hot_swap_checks_each_version(tmp_path):
    """--rate with --swap-ckpt: every admitted request answered, offered =
    admitted + shed, both versions served, each checked against its own
    model's predict."""
    _save_port_model(tmp_path / "v1", "nystrom", 1)
    _save_port_model(tmp_path / "v2", "rff", 2)
    # 1.4 s of arrivals after the swap: on a CPU the swap thread's first ops
    # start the math library's threads (tenths of a second), and the swap
    # must land before the last request
    stats = cluster_serve.main([
        "--requests", "1500", "--rate", "1000", "--ckpt", str(tmp_path / "v1"),
        "--swap-ckpt", str(tmp_path / "v2"), "--swap-after", "100",
        "--stats-json", str(tmp_path / "stats.json"), *SMALL])
    assert stats["mismatches"] == 0 and stats["errors"] == 0
    assert stats["served"] == stats["admitted"]
    assert stats["admitted"] + stats["shed"] == 1500
    assert set(stats["by_version"]) == {"1", "2"}
    assert stats["swap_at"] == 100 and stats["swap_s"] > 0
    assert json.loads((tmp_path / "stats.json").read_text())["served"] == stats["served"]


def test_sweep_selected_model_is_served():
    stats = cluster_serve.main(["--requests", "400", "--sweep-k-grid", "2,3",
                                "--sweep-restarts", "2", *SMALL])
    assert stats["mismatches"] == 0 and stats["served"] == 400


@pytest.mark.parametrize("method", ["nystrom", "rff"])
def test_reference_checkpoint_is_served_with_the_references_labels(tmp_path, monkeypatch,
                                                                   method):
    """--ckpt at a checkpoint the JAX package wrote: the labels the port's
    tier serves equal the JAX package's core.kkmeans.predict from the same
    checkpoint over the same request log."""
    X = _fit_rows()
    kw = dict(m=16) if method == "rff" else dict(l=48, m=32)
    JKernelKMeans(3, kernel="rbf", kernel_params={"gamma": 1.0 / 8}, method=method,
                  backend="local", iters=8, **kw).fit(X, key=jax.random.PRNGKey(4)).save(
                      tmp_path / "ref")
    futs = []

    class Recording(ServingTier):
        def submit_wait(self, *args, **kwargs):
            fut = super().submit_wait(*args, **kwargs)
            futs.append(fut)
            return fut

    monkeypatch.setattr(cluster_serve, "ServingTier", Recording)
    stats = cluster_serve.main(["--requests", "500", "--ckpt", str(tmp_path / "ref"), *SMALL])
    assert stats["mismatches"] == 0
    served = np.asarray([f.result().label for f in futs])
    # the CLI's request log: the same generator and seed in both packages
    X_req = j_blocks(0 + 7919, 500, 8, 3, block_rows=500, separation=4.0)[0].get(0)
    jmodel = jck.load_any_model(tmp_path / "ref")
    want = np.asarray(j_predict(X_req, jmodel.params, jmodel.centroids))
    np.testing.assert_array_equal(served, want)
    assert len(np.unique(want)) == 3


def test_stream_shard_backend_names_its_item(capsys):
    """``--backend stream_shard --device cpu`` fits through the sharded
    stream (one shard, ``[cpu]``) and serves with an exact replay."""
    stats = cluster_serve.main(["--backend", "stream_shard", "--requests", "300", *SMALL])
    assert stats["mismatches"] == 0
    assert "backend=stream_shard" in capsys.readouterr().out


def test_unknown_method_and_backend_fail_before_fitting():
    with pytest.raises(ValueError, match="unknown embedding"):
        cluster_serve.main(["--method", "magic", *SMALL])
    with pytest.raises(ValueError, match="unknown backend"):
        cluster_serve.main(["--backend", "mapreduce", *SMALL])
