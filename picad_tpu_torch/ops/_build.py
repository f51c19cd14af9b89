"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own
into `build/lib<name>-<source hash>.so` inside the package (a directory
.gitignore lists), at first use.  The hash covers the source and every
shared header `csrc/*.cuh` (hopper.cuh), so an edited source or header
is never served by a stale library.  Nothing here runs at
import time, and nothing touches nvcc until a kernel is launched or
`build()` is called.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

_LIBS: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when an up-to-date library was already built
    log: str  # nvcc's output, including ptxas's resource report


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """build/lib<name>-<hash>.so, the hash over csrc/<name>.cu and every
    csrc/*.cuh by name and content."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of picad_tpu_torch are built from source at first use"
        )
    return path


def build(names: list[str] | None = None) -> list[BuildResult]:
    """Compile every named source not yet built: one nvcc per source,
    all started together.  Raises with nvcc's output on a failure."""
    names = kernel_names() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, running = [], []
    for name in names:
        out = library_path(name)
        if out.exists():
            results.append(BuildResult(name, out, 0.0, "up to date"))
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, out, tmp, time.perf_counter(), proc))
    for name, out, tmp, t0, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
        results.append(BuildResult(name, out, time.perf_counter() - t0, log))
    return results


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
