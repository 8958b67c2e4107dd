"""The port's boundary: it imports neither JAX, nor the JAX package, nor
ml_dtypes (which ships with JAX), its entry
points run on the card unless the caller asks for the CPU, and chip_smoke.py
rehearses its path on the CPU without ever claiming a card run."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test process has both packages, the subprocesses not)
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_port_imports_neither_jax_nor_repro():
    modules = sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )
    assert "repro_torch.kernels.apnc_embed" in modules
    assert "repro_torch.kernels.flash_attention" in modules
    assert "repro_torch.launch.serve" in modules
    assert {"repro_torch.obs", "repro_torch.obs.tracer", "repro_torch.obs.metrics",
            "repro_torch.obs.export", "repro_torch.obs.report", "repro_torch.roofline.analysis",
            "repro_torch.core.baselines", "repro_torch.core.kkmeans", "repro_torch.core.nystrom",
            "repro_torch.core.stable", "repro_torch.configs.paper_datasets",
            "repro_torch.data.synthetic"} <= set(modules)
    assert {"repro_torch.serving", "repro_torch.serving.admission",
            "repro_torch.serving.registry", "repro_torch.serving.server",
            "repro_torch.serving.loadgen", "repro_torch.stream.microbatch",
            "repro_torch.launch.cluster_serve"} <= set(modules)
    assert {"repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.optim.schedule",
            "repro_torch.models.moe", "repro_torch.train.loop", "repro_torch.train.step",
            "repro_torch.launch.train", "repro_torch.models.mamba",
            "repro_torch.models.rwkv6"} <= set(modules)
    assert {"repro_torch.distributed.sharding", "repro_torch.distributed.parallel",
            "repro_torch.distributed.compression", "repro_torch.distributed.pipeline",
            "repro_torch.launch.elastic"} <= set(modules)
    examples = sorted(str(p) for p in (REPO / "examples").glob("torch_*.py"))
    assert len(examples) == 5, examples
    code = (
        "import importlib, importlib.util, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        f"for i, path in enumerate({examples!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'_example_{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


@pytest.mark.parametrize("entry", ["fit", "predict", "resolve", "stream_fit", "ooc_lloyd",
                                   "map_reduce", "stream_predict", "sweep", "serve", "lm_init",
                                   "legacy_fit_predict", "legacy_predict",
                                   "stream_fit_predict", "synthetic", "make_process_fn",
                                   "registry_register", "cluster_serve", "train",
                                   "batch_iterator", "lm_init_cache"])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.api import KernelKMeans
    from repro_torch.device import resolve_device
    from repro_torch.stream.blockstore import BlockStore
    from repro_torch.stream.engine import map_reduce
    from repro_torch.stream.lloyd import ooc_lloyd

    X = np.random.default_rng(0).standard_normal((200, 4)).astype(np.float32)
    store = BlockStore.from_array(X, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "fit":
            KernelKMeans(3, l=16, m=8).fit(X)
        elif entry == "predict":
            model = KernelKMeans(3, l=16, m=8, device="cpu").fit(X).model_
            model.predict(X[:5])
        elif entry == "stream_fit":
            KernelKMeans(3, l=16, m=8, method="rff").fit(store)
        elif entry == "ooc_lloyd":
            ooc_lloyd(store, 3, discrepancy="l2", init=torch.zeros((3, 4)))
        elif entry == "map_reduce":
            map_reduce(store, lambda b: b, lambda a, b: a, None)
        elif entry == "sweep":
            KernelKMeans(3, l=16, m=8, backend="stream").sweep(store, k_grid=[2, 3])
        elif entry == "serve":
            from repro_torch.launch import serve

            serve.main(["--gen", "2"])
        elif entry == "lm_init":
            from repro_torch.configs import get_arch, reduced
            from repro_torch.models import model as lm
            from repro_torch.models.common import TEST_POLICY

            lm.init(torch.Generator().manual_seed(0), reduced(get_arch("qwen1.5-0.5b")),
                    TEST_POLICY)
        elif entry == "lm_init_cache":
            from repro_torch.configs import get_arch, reduced
            from repro_torch.models import model as lm

            lm.init_cache(reduced(get_arch("jamba-1.5-large-398b")), 1, 4)
        elif entry in ("legacy_fit_predict", "legacy_predict"):
            from repro_torch.core import kkmeans
            from repro_torch.core.kernels_fn import Kernel

            cfg = kkmeans.APNCConfig(l=16, m=8, n_init=1)
            if entry == "legacy_fit_predict":
                kkmeans.fit_predict(0, X, Kernel("rbf", gamma=0.5), 3, cfg)
            res, params = kkmeans.fit_predict(0, X, Kernel("rbf", gamma=0.5), 3, cfg,
                                              device="cpu")
            kkmeans.predict(X[:5], params, res.centroids)
        elif entry == "stream_fit_predict":
            from repro_torch.core.kernels_fn import Kernel
            from repro_torch.stream.lloyd import stream_fit_predict

            stream_fit_predict(0, store, Kernel("rbf", gamma=0.5), 3)
        elif entry == "synthetic":
            from repro_torch.data.synthetic import gaussian_blobs

            gaussian_blobs(0, 10, 2, 2)
        elif entry in ("make_process_fn", "registry_register"):
            from repro_torch.serving import ModelRegistry, make_process_fn

            model = KernelKMeans(3, l=16, m=8, device="cpu").fit(X).model_
            if entry == "make_process_fn":
                make_process_fn(model, max_batch=8)
            ModelRegistry(max_batch=8).register("m", model)
        elif entry == "cluster_serve":
            from repro_torch.launch import cluster_serve

            cluster_serve.main(["--requests", "10", "--n-fit", "200", "--l", "16",
                                "--m", "8", "--iters", "2"])
        elif entry == "train":
            from repro_torch.launch import train

            train.main(["--arch", "qwen1.5-0.5b", "--steps", "1"])
        elif entry == "batch_iterator":
            from repro_torch.configs import get_arch, reduced
            from repro_torch.data.tokens import batch_iterator

            next(batch_iterator(reduced(get_arch("qwen1.5-0.5b")), 2, 8))
        elif entry == "stream_predict":
            est = KernelKMeans(3, l=16, m=8, backend="stream", device="cpu").fit(store)
            est.device = None
            est.predict(store)
        else:
            resolve_device(None)


def test_policy_rejects_what_this_slice_has_not_ported():
    """Every setting the JAX package accepts, the port accepts; what the JAX
    package rejects, the port rejects too."""
    from repro_torch.policy import ComputePolicy

    assert ComputePolicy(precision="bf16").precision == "bf16"
    for codec in ("f32", "bf16", "int8"):
        assert ComputePolicy(cache_dtype=codec).cache_dtype == codec
    with pytest.raises(ValueError, match="unknown cache_dtype"):
        ComputePolicy(cache_dtype="fp4")
    with pytest.raises(ValueError):
        ComputePolicy(precision="f16")
    with pytest.raises(ValueError):
        ComputePolicy(sstep=0)


def test_chip_smoke_cpu_rehearsal():
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--cpu-rehearsal"],
                         cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    phases = [line.get("phase") for line in lines]
    assert phases == ["device", "data", "parity", "main", "agreement", "host_copy", "stream",
                      "rff", "sweep", "shard", "persist", "baselines", "obs", "serve",
                      "examples", "lm_serve", "lm_train", "lm_ssm", "lm_ssm_train", "lm_mesh",
                      "lm_mesh_ssm", "dryrun", "timing", "done"]
    assert not any(line.get("ok") for line in lines)
    examples = lines[phases.index("examples")]
    assert set(examples["scripts"]) == {"torch_quickstart", "torch_stream_quickstart",
                                        "torch_covtype_scale", "torch_activation_clustering",
                                        "torch_train_lm"}
    assert examples["temp_dir_removed"] and not any(examples["launches"].values())
    for name in ("torch_quickstart", "torch_stream_quickstart"):
        res = examples["scripts"][name]["result"]
        assert res["replay_identical"] == res["served_match_fit"] == res["served"] == 200
    assert examples["scripts"]["torch_covtype_scale"]["result"]["backend"] == "stream_shard"
    for name in ("torch_activation_clustering", "torch_train_lm"):
        res = examples["scripts"][name]["result"]
        assert res["loss_last"] < res["loss_first"]
    ssm_train = lines[phases.index("lm_ssm_train")]
    for part in ("a_rwkv6", "b_jamba"):
        run = ssm_train[part]
        assert run["loss_last"] < run["loss_first"] and len(run["split_s"]) == run["steps"]
        assert run["dryrun_placement"]["total_bytes"] > 0
    assert ssm_train["b_jamba"]["cuts"]["experts"] == [16, 2]
    assert ssm_train["b_jamba"]["moments_dtype"] == "bfloat16"
    assert all(r["loss_rel_diff"] <= 2e-4 and r["worst_grad_rel"] <= 2e-3
               for r in ssm_train["c_card_vs_cpu"].values())
    train = lines[phases.index("lm_train")]
    assert train["a_dense"]["loss_last"] < train["a_dense"]["loss_first"]
    assert all(g["grads"][n]["rel"] <= 1e-4 for g in train["b_attention_gradients"]
               for n in ("dq", "dk", "dv"))
    assert train["c_kernel_vs_plain_step"]["projections_with_nonzero_grad"] == 12
    assert train["d_crash_and_resume"]["bitwise_equal"]
    assert train["d_crash_and_resume"]["temp_dir_removed"]
    assert min(train["e_moe"]["aux"]) > 0 and train["flash_launches"] == 0
    mesh = lines[phases.index("lm_mesh")]
    assert set(mesh["a_training"]["runs"]) == {"one_device", "1x2", "2x1", "2x2"}
    assert all(max(r["loss_rel_diff"]) <= 1e-4 for k, r in mesh["a_training"]["runs"].items()
               if k != "one_device")
    assert mesh["b_serving"]["teacher_forced_max_abs_diff"] <= mesh["b_serving"]["limit"]
    assert mesh["c_seq_sharded_decode"]["max_abs_diff"] < 2e-3
    assert mesh["d_int8_ddp"]["final_loss"] < 1e-2 and mesh["e_pipeline"]["grad_err"] < 1e-4
    assert all(r["bitwise_equal"] for r in mesh["f_elastic"]["restores"].values())
    assert mesh["f_elastic"]["temp_dir_removed"] and mesh["flash_launches"] == 0
    ssm = lines[phases.index("lm_mesh_ssm")]
    assert set(ssm["g_rwkv6"]["meshes"]) == {"1x2", "2x2"} and set(ssm["h_jamba"]["meshes"]) == {
        "1x2"}
    assert all(max(r["prefill_max_abs_diff"], r["teacher_forced_max_abs_diff"]) <= ssm[p]["limit"]
               for p in ("g_rwkv6", "h_jamba_f32") for r in ssm[p]["meshes"].values())
    assert ssm["h_jamba"]["limit"] is None and "routing_replayed" in ssm["h_jamba"]["meshes"]["1x2"]
    assert all(r["loss_rel_diff"] <= 1e-4 and r["grad_norm_rel_diff"] <= 1e-3
               for a in ssm["i_training"].values() for k, r in a["runs"].items()
               if k != "one_device")
    dry = lines[phases.index("dryrun")]["a_card_vs_meta"]
    assert dry["gemm_flops"]["meta"] == dry["gemm_flops"]["card"] > 0
    assert all(b == dry["per_coordinate_bytes"]["spec"]
               for b in dry["per_coordinate_bytes"]["card_blocks"].values())
    main = lines[phases.index("main")]
    assert main["nmi"] > 0.9 and main["launches"] == {"apnc_embed": 0, "apnc_assign": 0,
                                                      "kmeanspp_seed": 0}
    stream = lines[phases.index("stream")]
    assert stream["nmi"] > 0.9 and stream["vs_local"]["label_agreement"] == 1.0
    assert stream["same_params_as_local"] and not any(stream["launches"].values())
    assert stream["engine"]["blocks_read"] == stream["passes"] * stream["num_blocks"]
    rff = lines[phases.index("rff")]
    assert rff["vs_local"]["label_agreement"] >= 0.995 and not any(rff["launches"].values())
    sweep = lines[phases.index("sweep")]
    assert sweep["b_f32_vs_stream_fit"]["bitwise_identical"]
    assert sweep["equal_centroids"]["chain_label_mismatches"] == 0
    assert sweep["a_int8"]["compression_ratio"] > 3.9 and sweep["c_bf16"]["compression_ratio"] == 2
    assert {d["route"] for d in lines[phases.index("parity")]["fused_dequant"]} == {"fused"}
    seeds = lines[phases.index("parity")]["kmeanspp_seed"]
    assert [(r["disc"], r["n"]) for r in seeds] == [("l2", 1024), ("l1", 1024), ("l2", 128),
                                                    ("l1", 128)]
    flash = lines[phases.index("parity")]["flash_attention"]
    assert {(c["window"], c["dtype"]) for c in flash} == {
        (w, dt) for w in (0, 50, 4096) for dt in ("float32", "bfloat16")}
    # each model shard's attention of phase lm_mesh (reduced: one or two heads
    # a shard), at every window and dtype
    mesh_shapes = {tuple(c["shape"]) for c in flash if c["lm_mesh_shard"]}
    assert mesh_shapes == {(4, 64, 1, 16), (2, 64, 2, 16), (2, 64, 1, 16), (4, 32, 1, 16)}
    assert sum(c["lm_mesh_shard"] for c in flash) == len(mesh_shapes) * 6
    shard = lines[phases.index("shard")]
    assert shard["cards"]["bitwise_phase_stream"] and shard["chaos"]["bitwise_fault_free"]
    assert shard["equal_centroids"]["label_mismatches"] == 0 and shard["equal_centroids"]["g_equal"]
    assert shard["chaos"]["worker_deaths"] >= 1 and not any(shard["launches"].values())
    assert shard["lockstep"]["reductions"] == shard["lockstep"]["passes"] - 1
    persist = lines[phases.index("persist")]
    assert persist["temp_dir_removed"] and not any(persist["launches"].values())
    for name in ("local", "rff"):
        saved = persist["save_load"][name]
        assert saved["predict_bitwise"] and saved["centroids_bitwise"] and saved["params_bitwise"]
    for name in ("stream_resume", "minibatch_resume"):
        res = persist[name]
        assert res["iterations_skipped"] >= 1 and res["counters"]["ckpt_resumes"] >= 1
        assert res["labels_bitwise"] and res["n_iter_equal"] and res["inertia_bitwise"]
    sweep_res = persist["sweep_resume"]
    assert sweep_res["cache_embedding_passes"] == [1, 0] and sweep_res["resumed"] == [False, True]
    assert sweep_res["inertia_bitwise"] and sweep_res["labels_bitwise"]
    assert sweep_res["load_any_model_predicts_like_best"]
    assert sweep_res["y_bin_bytes"] == persist["n"] * persist["m"]
    pf = persist["partial_fit"]
    assert pf["rows_seen"] == persist["n"] and pf["kernel_vs_plain"]["label_mismatches"] == 0
    base = lines[phases.index("baselines")]
    assert set(base["runs"]) == {"exact_kernel_kmeans", "approx_kkm", "rff_kmeans",
                                 "svd_rff_kmeans", "two_stage", "fit_predict"}
    assert all(0.0 <= r["nmi"] <= 1.0 and 0.0 <= r["nmi_vs_exact"] <= 1.0
               for r in base["runs"].values())
    assert base["runs"]["exact_kernel_kmeans"]["nmi"] > 0.8
    assert base["runs"]["exact_kernel_kmeans"]["nmi_vs_exact"] == 1.0
    assert base["predict"]["equals_cluster_model"] and base["predict"]["nmi"] > 0.8
    assert base["gram"]["bytes"] == base["n"] ** 2 * 4
    cvc = base["card_vs_cpu"]
    assert all(cvc[name]["label_mismatches"] == 0 for name in base["runs"] if name in cvc)
    assert cvc["approx_kkm_lockstep"]["steps"] == 20 and not cvc["approx_kkm"]["gated"]
    ob = lines[phases.index("obs")]
    assert ob["report_count"] >= 10  # main, stream, rff x 2, sweep x 3, persist's
    assert {r["kind"] for r in ob["reports"]} == {"fit", "sweep"}
    for r in ob["reports"]:
        if r["backend"] in ("stream", "minibatch") and r["kind"] == "fit":
            assert r["fused_dispatches"] == r["blocks_read"] == r["passes"] * stream["num_blocks"]
            assert r["per_device_blocks"] == {"cpu": r["blocks_read"]}
    traced = ob["traced_stream_fit"]
    assert traced["lanes"] == ["main", "producer:cpu"] and traced["labels_as_phase_stream"]
    assert traced["span_counts"]["h2d"] == traced["passes"] * stream["num_blocks"]
    assert traced["span_counts"]["lloyd.fused_step"] == traced["span_counts"]["h2d"]
    assert all(traced["span_counts"][f"phase.{p}"] == 1
               for p in ("reservoir", "embed_fit", "seed", "lloyd"))
    roof = ob["roofline"]
    assert roof["peak_flops"] == 67e12 and roof["hbm_bytes_per_s"] == 3.35e12
    assert roof["join_pass_record"]["passes"] == traced["passes"]
    serve = lines[phases.index("serve")]
    a, b, c = serve["a_closed_loop"], serve["b_open_loop_swap"], serve["c_two_models"]
    assert a["served"] == serve["requests"] and a["mismatches"] == 0
    assert a["batch_size"]["sum"] == serve["requests"] and a["batch_size"]["max"] <= 64
    assert b["mismatches"] == 0 and b["served"] == b["admitted"] and b["errors"] == 0
    assert b["admitted"] + b["shed"] == serve["requests"] and set(b["by_version"]) == {"1", "2"}
    assert c["closed"]["mismatches"] == 0 and c["closed"]["served"] == serve["requests"]
    assert c["closed"]["by_model"] == {"nystrom": serve["requests"] // 2,
                                       "rff": serve["requests"] // 2}
    over = c["overload"]
    assert over["offered"] == over["admitted"] + over["shed"] and over["errors"] == 0
    assert over["mismatches"] == 0
    assert not any(serve["launches"].values())  # the CPU route launches no kernel
    lm = lines[phases.index("lm_serve")]
    assert lm["arch"] == "qwen1.5-0.5b-smoke" and lm["flash_attention_launches"] == 0
    assert lm["vs_plain"]["max_abs_diff"] == 0.0  # the CPU route is the plain version
    dvp = lm["decode_vs_prefill"]
    assert all(dvp["max_abs_diff"][key] <= dvp["limit"][key] for key in dvp["limit"])
    assert dvp["limit"]["reduced_bf16_cache"] == dvp["limit"]["f32_cache"] == 2e-3
    assert lm["int8_vs_bf16"]["max_abs_diff"] < 2e-2


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    bare = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone), "--cpu-rehearsal"], cwd=tmp_path,
                         env=bare, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header rebuilds every library whose source
    includes it, directly or through another header, and no other."""
    import shutil

    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build._target(name) for name in build.SOURCES}
    epilogue = csrc / "lloyd_epilogue.cuh"
    epilogue.write_text(epilogue.read_text() + "\n")
    after = {name: build._target(name) for name in build.SOURCES}
    assert [n for n in build.SOURCES if after[n] != before[n]] == [
        "apnc_assign", "lloyd_step", "dequant_step"]
    shared = csrc / "tile_math.cuh"
    shared.write_text(shared.read_text() + "\n")
    assert [n for n in build.SOURCES if build._target(n) == after[n]] == [
        "dequant_step", "flash_attention", "kmeanspp_seed"]
    again = {name: build._target(name) for name in build.SOURCES}
    copies = csrc / "cp_async.cuh"  # through apnc_mainloop.cuh for apnc_embed
    copies.write_text(copies.read_text() + "\n")
    assert [n for n in build.SOURCES if build._target(n) != again[n]] == [
        "apnc_embed", "apnc_assign", "lloyd_step", "rff_embed", "dequant_step",
        "flash_attention"]
    again = {name: build._target(name) for name in build.SOURCES}
    mainloop = csrc / "rff_mainloop.cuh"
    mainloop.write_text(mainloop.read_text() + "\n")
    assert [n for n in build.SOURCES if build._target(n) != again[n]] == [
        "lloyd_step", "rff_embed"]
