"""Build the CUDA sources into shared libraries and load them with ctypes.

The sources under ``csrc/`` have a plain C interface (``extern "C"``
launchers returning ``cudaError_t``), so ``nvcc`` compiles each in seconds,
with no PyTorch headers.  Each source becomes its own library, and the
first load builds every missing one at once: one ``nvcc`` per source, all
started together.  The libraries go into ``build/kernels/`` at the root of
the checkout, named by a hash of their source and the flags: an unchanged
source is never rebuilt, and an edited one never loads a stale library.
Beside each library its build's output (the ptxas register and spill
report) is kept, so a cached build still reports it.  A missing ``nvcc``
or a failed build raises; nothing falls back.

A kernel generated from a descriptor's body (the 3DBLOCK template of
``csrc/stencil3d.cu`` built with ``-DSTENCIL3D_GENERATED`` around the
body's header, :func:`load_generated`) is built the same way, when it is
first launched, into a library named by a hash of the source, the header
and the flags.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {name: CSRC / f"{name}.cu"
           for name in ("stencil3d", "jacobi", "attention", "ssd")}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# per library: where it is, what its build printed (ptxas register / spill
# report) and how long it took
build_info: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is absent, one ``nvcc`` each, all
    running at once; return the libraries by name."""
    libs = {name: library_path(name) for name in SOURCES}
    todo = {}
    for name, lib in libs.items():
        if lib.is_file():
            log = lib.with_suffix(".log")
            build_info.setdefault(name, dict(
                path=str(lib), seconds=0.0, cached=True,
                log=log.read_text() if log.is_file() else ""))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        todo[name] = (proc, cmd, tmp, time.perf_counter())
    failed = []
    for name, (proc, cmd, tmp, t0) in todo.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{log}")
            continue
        libs[name].with_suffix(".log").write_text(log)   # the ptxas report
        os.replace(tmp, libs[name])  # atomic: a loader sees all or nothing
        build_info[name] = dict(path=str(libs[name]), seconds=seconds,
                                cached=False, log=log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


GENERATED_FLAGS = ("-DSTENCIL3D_GENERATED",)
GENERATED_HEADER = "stencil3d_generated_body.cuh"


@functools.lru_cache(maxsize=None)
def load_generated(tag: str, header: str) -> ctypes.CDLL:
    """The 3DBLOCK template of ``csrc/stencil3d.cu`` built around
    ``header`` (a generated ``gen_body``), loaded once per process; built
    by one ``nvcc`` if its library is absent.  ``tag`` names the library
    (the descriptor's name)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + GENERATED_FLAGS).encode())
    h.update(SOURCES["stencil3d"].read_bytes())
    h.update(header.encode())
    lib = BUILD_DIR / f"libstencil3d-{tag}-{h.hexdigest()[:16]}.so"
    key = f"stencil3d:{tag}"
    if lib.is_file():
        log = lib.with_suffix(".log")
        build_info.setdefault(key, dict(
            path=str(lib), seconds=0.0, cached=True,
            log=log.read_text() if log.is_file() else ""))
    else:
        inc = lib.with_suffix("")          # the header's own directory
        inc.mkdir(parents=True, exist_ok=True)
        (inc / GENERATED_HEADER).write_text(header)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, *GENERATED_FLAGS, "-I", str(inc),
               "-o", tmp, str(SOURCES["stencil3d"])]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}")
        lib.with_suffix(".log").write_text(proc.stdout)
        os.replace(tmp, lib)
        build_info[key] = dict(path=str(lib), cached=False,
                               seconds=time.perf_counter() - t0,
                               log=proc.stdout)
    return ctypes.CDLL(str(lib))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library built from ``SOURCES[name]``, loaded once per process."""
    return ctypes.CDLL(str(build_all()[name]))
