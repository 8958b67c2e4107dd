"""The benchmark's import boundary: what bench/run.py loads holds neither JAX
nor the JAX package, and nothing under bench/ reads the JAX package's old
benchmark folder."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

def test_run_py_and_every_file_it_finds_load_no_jax():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    kinds = {json.loads(p.read_text())["kind"] for p in (BENCH / "traffic").glob("*.json")}
    code = "\n".join([
        "import importlib.util, json, sys",
        f"spec = importlib.util.spec_from_file_location('bench_run', {str(BENCH / 'run.py')!r})",
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)",
        f"spec = importlib.util.spec_from_file_location('bench_controls', {str(BENCH / 'controls.py')!r})",
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)",
        "from bench.harness import planted, runner, small",
        "from bench.reference import apnc, blobs, judge",
        f"for name in {[m['name'] for m in spec['per_layer']]!r}: runner.reader(name)",
        f"for cell in {[w['name'] for w in spec['workloads']]!r}: runner.cell_spec(cell)",
        f"for kind in {sorted(kinds)!r}: runner.traffic_kind(kind)",
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "bench" in loaded
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)


def test_nothing_under_bench_reads_the_old_benchmarks_folder():
    old = "bench" + "marks"
    pattern = re.compile(rf"\b{old}\b")
    hits = [str(p.relative_to(ROOT)) for p in BENCH.rglob("*")
            if p.is_file() and p.suffix in (".py", ".json", ".txt", ".toml", ".csv")
            and pattern.search(p.read_text())]
    assert not hits, hits
