"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into its own shared library, loaded with `ctypes`.
Builds happen at first use, never at import, into `build/repro_torch/`
at the root of the checkout (listed in `.gitignore`).  The library's
file name carries a hash of the source, the headers of `csrc/` it
includes (`#include "..."`) and the flags, so an edited source or header
is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
# --split-compile=0: the device code's optimisation split over every core
# (chip_smoke.py's build line on the 8 cores beside an H100: the flash
# library's 77 kernels in 64-105 s, against 167 s without it)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0"]

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def _sources(path: pathlib.Path,
             seen: list[pathlib.Path]) -> list[pathlib.Path]:
    """`path` and the headers of `csrc/` it includes, recursively, each
    once, in the order first met."""
    if path not in seen:
        seen.append(path)
        for inc in re.findall(rb'^\s*#include\s+"([^"]+)"',
                              path.read_bytes(), re.M):
            _sources(CSRC / inc.decode(), seen)
    return seen


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu", []):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, dict]:
    """Compile every named source that has no up-to-date library, all
    `nvcc` processes started together.  Returns, per name, the library
    path, whether it was already built, the seconds the build took and
    the compiler's output (`-Xptxas -v`: registers, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        out[name] = {"path": str(lib), "cached": lib.exists(),
                     "seconds": 0.0, "log": ""}
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        out[name]["seconds"] = time.perf_counter() - t0
        out[name]["log"] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
