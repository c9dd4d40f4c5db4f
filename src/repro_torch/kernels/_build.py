"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``src/repro_torch/csrc/<name>.cu`` compiles on its own, with a plain C
interface and no PyTorch headers, into ``build/kernels/lib<name>.so`` at
the repository root (a directory git ignores):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>.so <name>.cu

That takes seconds per file, where ``torch.utils.cpp_extension.load`` takes
minutes. ``build_all`` starts one ``nvcc`` per source, all at once. A library
is rebuilt when its source, or any shared header ``csrc/*.cuh`` (which any
source may include), is newer than it. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (CUDA_HOME/bin/nvcc or PATH)")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build_all(names=None, force: bool = False) -> dict:
    """Compile the named sources (default: every ``csrc/*.cu``) in parallel.
    Returns ``{name: ptxas report}`` for the sources compiled by this call.
    Raises ``KernelBuildError`` with nvcc's output if any build fails."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    reports, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[n] = out
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return reports


class _Libraries:
    """Loaded libraries, one per source, each loaded once per process."""

    def __init__(self):
        self._libs: dict[str, ctypes.CDLL] = {}

    def get(self, name: str, signatures: dict) -> ctypes.CDLL:
        lib = self._libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            self._libs[name] = lib
        return lib


LIBRARIES = _Libraries()


_SMS: dict = {}


def sm_count(device) -> int:
    """The SM count of a CUDA device (read once per device)."""
    import torch
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
