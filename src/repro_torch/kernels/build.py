"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

at first use, under ``build/repro_torch/`` in the checkout. The file name
carries a hash of the source, of every ``csrc/*.cuh`` header it includes and
of the flags, so an edited source or header rebuilds and an unchanged one
loads from the cache. ``build_all()`` starts one nvcc per
source, all at once. A failed build raises with nvcc's output: nothing falls
back to the plain PyTorch versions. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("apnc_embed", "apnc_assign", "lloyd_step", "rff_embed", "dequant_step",
           "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
#: Seconds each nvcc took in this process (absent for a cached library).
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found on PATH or under /usr/local/cuda/bin; the CUDA "
        "toolkit is needed to build the repro_torch kernels"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def _headers(path: Path, seen: set[Path]) -> list[Path]:
    """The csrc headers ``path`` includes, directly or through another header,
    each once, in the order they are first met."""
    found = []
    for name in _INCLUDE.findall(path.read_bytes()):
        header = (path.parent / name.decode()).resolve()
        if header not in seen:
            seen.add(header)
            found += [header, *_headers(header, seen)]
    return found


def _target(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in _headers(source, set()):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> str:
    """nvcc's ``-Xptxas -v`` output (registers, shared memory, spills) saved
    beside the library when it was built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every stale source at once (one nvcc each) and return the
    library paths. Raises RuntimeError with nvcc's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in names}
    procs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, time.perf_counter())
    errors = []
    for name, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        targets[name].with_suffix(".log").write_text(out)
        os.replace(tmp, targets[name])
    if errors:
        raise RuntimeError("\n\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        _LIBS[name] = lib
    return lib


#: The library each name was last configured as: a launch pays for no ctypes
#: set-up, and a library swapped into ``_LIBS`` is configured anew.
_CONFIGURED: dict[str, ctypes.CDLL] = {}


def configured(name: str, configure) -> ctypes.CDLL:
    """``load(name)``, with ``configure(lib)`` (argument types, checks against
    the Python side) run once for each library object."""
    lib = load(name)
    if _CONFIGURED.get(name) is not lib:
        configure(lib)
        _CONFIGURED[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
