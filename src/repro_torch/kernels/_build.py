"""Build and load the port's CUDA C++ kernels (no ``repro`` counterpart).

At first use every ``src/repro_torch/csrc/*.cu`` is compiled by its own
``nvcc`` process, all started together, into a shared library with a
plain C interface under ``build/repro_torch/`` at the checkout root
(listed in ``.gitignore``).  A library's file name carries a hash of its
source, of every shared header ``csrc/*.cuh`` and of the compiler flags,
so an edited source or header is rebuilt and an unchanged one is loaded
from the previous build.  Libraries are loaded
with ``ctypes``.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

from repro_torch.obs import clock

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale source in parallel; return {stem: library}."""
    srcs = sorted(CSRC.glob("*.cu"))
    out = {s.stem: _target(s) for s in srcs}
    todo = [s for s in srcs if not out[s.stem].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs: List = []
    t0 = clock.perf_counter()
    for s in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        log = open(BUILD_DIR / f"{s.stem}.log", "w")
        p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(s)],
                             stdout=log, stderr=subprocess.STDOUT)
        procs.append((s, tmp, p, log))
    ends: Dict[str, float] = {}

    def reap(src: Path, proc) -> None:
        proc.wait()
        ends[src.stem] = clock.perf_counter() - t0

    waiters = [threading.Thread(target=reap, args=(s, p))
               for s, _, p, _ in procs]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failed = []
    for s, tmp, p, log in procs:
        log.write(f"nvcc wall time {ends[s.stem]:.1f} s ({len(todo)} "
                  "sources compiled in parallel)\n")
        log.close()
        if p.returncode != 0:
            failed.append(s.name)
            os.unlink(tmp)
        else:
            os.replace(tmp, out[s.stem])
    if failed:
        logs = "\n".join((BUILD_DIR / f"{Path(f).stem}.log").read_text()[-4000:]
                         for f in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on demand)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[stem]))
            _libs[stem] = lib
        return lib


def build_log(stem: str) -> str:
    """nvcc's output (``-Xptxas=-v``: registers, shared memory, spills)
    from the last build of ``csrc/<stem>.cu`` in this checkout."""
    p = BUILD_DIR / f"{stem}.log"
    return p.read_text() if p.exists() else ""
