"""Build the port's CUDA sources with nvcc and load them with ctypes.

``csrc/<name>.cu`` is compiled on first use into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared ...

into ``build/repro_torch_kernels/<name>-<hash>.so`` under the repository
root, keyed by a hash of the flags, the library's own source and the shared
headers (``csrc/*.cuh``), so an edited source rebuilds its own library and
no other.  ``defines`` (pairs of name and value, passed as ``-Dname=value``
and hashed with the flags) carry sizes that a wrapper owns into its
source.  The compiler's ``-Xptxas -v`` report (registers, spills) is kept
beside the library as ``.log``.  ``build_many`` starts one nvcc per source,
all together, and waits for all of them.
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    cands = [os.path.join(os.environ[k], "bin", "nvcc")
             for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built with the CUDA toolkit on the GPU machine")


def define_flags(defines) -> tuple:
    return tuple(f"-D{k}={v}" for k, v in defines)


def library_path(name: str, defines=()) -> Path:
    """Content-keyed output path of ``csrc/<name>.cu`` built with
    ``defines``."""
    h = hashlib.sha256()
    for part in (*NVCC_FLAGS, *define_flags(defines), name):
        h.update(part.encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_many(names, defines=None) -> dict:
    """Compile every ``csrc/<name>.cu`` of ``names`` whose library is not
    built yet, with ``defines[name]`` where given, one nvcc process per
    source, all started together; returns ``{name: seconds}`` (0.0 where
    there was nothing to do).  Raises with the compiler's output if any
    nvcc fails."""
    defines = defines or {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    running = {}
    t0 = time.perf_counter()
    for name in names:
        flags = define_flags(defines.get(name, ()))
        out = library_path(name, defines.get(name, ()))
        if out.exists() or name in running:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, out, tmp)
    failures = []
    for name, (proc, out, tmp) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"CUDA build of {name} failed: nvcc exited "
                            f"{proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build(name: str, defines=()) -> float:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the build's seconds (0.0 when there was nothing to do)."""
    return build_many((name,), {name: defines})[name]


def build_log(name: str, defines=()) -> str:
    """nvcc/ptxas output of the current build of ``name`` ('' if none)."""
    log = library_path(name, defines).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    build(name, defines)
    return ctypes.CDLL(str(library_path(name, defines)))
