"""Build the hand-written CUDA kernels and load them through ``ctypes``.

Every ``csrc/*.cu`` file has a plain C interface and compiles on its own
into one shared library for ``sm_90a`` (Hopper). The first call to
:func:`library` starts one ``nvcc`` per source, all at once, waits for all
of them, and loads the results; later calls reuse the loaded libraries.
Outputs go to ``build/kernels/`` at the root of the checkout, named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is not. Nothing here runs at import time: the CPU tests
import every module and never build.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
TRITON_CACHE_DIR = BUILD_DIR.parent / "triton"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path():
    """``nvcc`` from ``CUDA_HOME``, else ``/usr/local/cuda``, else ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "are built from source at first use")
    return found


def _target(src, nvcc, flags=NVCC_FLAGS):
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        (nvcc,) + tuple(flags)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _compile(items, nvcc):
    """Start one ``nvcc`` for each (source, flags) item not built yet, all
    at once, and wait for all of them. Returns the compiler log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, log = {}, []
    try:
        for src, flags in items:
            so = _target(src, nvcc, flags)
            if so.exists() or so in jobs:
                continue
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *flags, "-o", str(tmp), str(src)]
            jobs[so] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, " ".join(flags[len(NVCC_FLAGS):]))
        for so, (proc, tmp, extra) in jobs.items():
            out, _ = proc.communicate()
            name = so.stem.rsplit("-", 1)[0]
            log.append(f"== {name}.cu {extra}".rstrip() + f"\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu {extra} "
                                   f"(exit {proc.returncode}):\n{out}")
            os.replace(tmp, so)
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return "\n".join(log)


@functools.cache
def build_all():
    """Compile every ``csrc/*.cu`` in parallel (one ``nvcc`` each) and load
    them. Returns ``(libraries by source stem, seconds, compiler log)``."""
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    srcs = sorted(CSRC.glob("*.cu"))
    log = _compile([(src, NVCC_FLAGS) for src in srcs], nvcc)
    libs = {src.stem: ctypes.CDLL(str(_target(src, nvcc))) for src in srcs}
    return libs, time.perf_counter() - t0, log


def variants(name, defines):
    """Measurement builds of ``csrc/<name>.cu``: one for each dict of
    preprocessor macros in ``defines`` (``{"SFPL_SLSTM_PROBE": 1}`` is
    ``-DSFPL_SLSTM_PROBE=1``), compiled at once beside the default builds.
    Returns ``(libraries in the order of defines, compiler log)``."""
    nvcc = nvcc_path()
    src = CSRC / f"{name}.cu"
    flags = [NVCC_FLAGS + tuple(f"-D{k}={v}" for k, v in d.items())
             for d in defines]
    log = _compile([(src, f) for f in flags], nvcc)
    return [ctypes.CDLL(str(_target(src, nvcc, f))) for f in flags], log


def import_triton():
    """Import Triton with its compile cache in ``build/triton/`` of the
    checkout (unless ``TRITON_CACHE_DIR`` is set), not under ``$HOME``."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(TRITON_CACHE_DIR))
    import triton
    return triton


def library(name):
    """The loaded shared library built from ``csrc/<name>.cu``."""
    return build_all()[0][name]


def check(err, what):
    """Raise if a C entry point reported a CUDA error (it returns
    ``cudaGetLastError()`` right after its launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch "
                           f"(cudaGetLastError)")
