"""Build the port's native libraries from the sources in the checkout.

Shared libraries with plain C interfaces, loaded with ctypes:

* ``attention`` — ``nn/csrc/attention.cu``, the attention kernels K1, K2,
  K5a and K5b;
* ``mlp_block`` — ``nn/csrc/mlp_block.cu``, the fused MLP half-block K4;
* ``batchnorm`` — ``nn/csrc/batchnorm.cu``, BatchNorm's forward and
  backward kernels K6;
* ``eb_likelihood`` — ``coding/csrc/eb_likelihood.cu``, the
  entropy-bottleneck likelihood K3;
* ``rans`` — ``coding/csrc/rans.cpp``, the host rANS codec.

A ``.cu`` source is compiled with nvcc for ``sm_90a``, a ``.cpp`` one with
g++ for the build host's ISA. All go into ``lossyless_tpu_torch/_build/``
at first use, under a file name keyed on a hash of the sources, the
headers they include (``HEADERS``: ``nn/csrc/hopper.cuh``, the Hopper
helpers ``attention.cu`` and ``mlp_block.cu`` share) and the compile command
(plus the host's ISA for the ``-march=native`` codec), so an edited source
or header, or another CPU, never picks up a stale library. Each build
writes a per-pid temp file and ``os.replace``s it into place: processes
racing the first build never interleave writes into one library. A failed
build raises; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "_build"

SOURCES = {
    "attention": (_PKG / "nn" / "csrc" / "attention.cu",),
    "mlp_block": (_PKG / "nn" / "csrc" / "mlp_block.cu",),
    "batchnorm": (_PKG / "nn" / "csrc" / "batchnorm.cu",),
    "eb_likelihood": (_PKG / "coding" / "csrc" / "eb_likelihood.cu",),
    "rans": (_PKG / "coding" / "csrc" / "rans.cpp",),
}
# headers a source includes: not compiled on their own, but an edit to one
# must rebuild every library that includes it
_HOPPER = _PKG / "nn" / "csrc" / "hopper.cuh"
HEADERS = {"attention": (_HOPPER,), "mlp_block": (_HOPPER,)}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _host_stamp() -> str:
    """The build host's ISA: a cached -march=native library must never be
    reused on a CPU lacking the build host's extensions (it loads fine via
    ctypes but dies with SIGILL on the first call, no exception to catch)."""
    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    ident += " " + line
                    break
    except OSError:
        pass
    return ident


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
            nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (neither on PATH nor under "
                           "CUDA_HOME); the CUDA kernels cannot be built")
    return nvcc


def _is_cuda(name: str) -> bool:
    return SOURCES[name][0].suffix == ".cu"


def _command(name: str, out: Path) -> list[str]:
    srcs = [str(s) for s in SOURCES[name]]
    if _is_cuda(name):
        return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-o", str(out), *srcs]
    return ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
            "-pthread", *srcs, "-o", str(out)]


def library_path(name: str) -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256()
    for src in (*SOURCES[name], *HEADERS.get(name, ())):
        h.update(src.read_bytes())
    # the command minus its tool path and output name: a flag change rebuilds
    h.update(" ".join(_command(name, Path("out"))[1:]).encode())
    if not _is_cuda(name):
        h.update(_host_stamp().encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, float]:
    """Build the named libraries that are not cached yet, all in parallel.

    Returns the seconds each build took (0.0 when cached). The compiler's
    output (nvcc's ``-Xptxas -v`` register and shared-memory report) is
    kept beside each library as ``<library>.log``.
    """
    names = names or tuple(SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("native build failed: " + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output from the build of the current sources."""
    path = library_path(name)
    log = path.with_name(path.name + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The named library, built at first use and loaded once per process."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            build(name)
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]
