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


def _target(src, nvcc):
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        (nvcc,) + NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


@functools.cache
def build_all():
    """Compile every ``csrc/*.cu`` in parallel (one ``nvcc`` each) and load
    them. Returns ``(libraries by source stem, seconds, compiler log)``."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs, log = {}, []
    try:
        for src in sorted(CSRC.glob("*.cu")):
            so = _target(src, nvcc)
            if so.exists():
                continue
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so)
        for name, (proc, tmp, so) in jobs.items():
            out, _ = proc.communicate()
            log.append(f"== {name}.cu\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu "
                                   f"(exit {proc.returncode}):\n{out}")
            os.replace(tmp, so)
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    libs = {src.stem: ctypes.CDLL(str(_target(src, nvcc)))
            for src in sorted(CSRC.glob("*.cu"))}
    return libs, time.perf_counter() - t0, "\n".join(log)


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
