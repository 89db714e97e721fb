"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each source in ``csrc/`` has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into one shared library under
``build/kernels/`` at the repo root; the file name carries a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and a stale library is never loaded. :func:`build_all` starts one ``nvcc`` per source, all at
once. Nothing here runs at import time: the CPU tests import every module
of the package on a machine with no ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception. Launch counts live
in :data:`LAUNCHES`, one per kernel wrapper, incremented where the wrapper
launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("selective_lut", "fused_two_stage", "pq_scan", "hit_count",
           "sphere_hits", "fused_three_stage", "ivf_filter")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel wrapper since the last :func:`reset_launches`;
#: ``sphere_probe``: launches of ``sphere_hits.cu``'s probe entry (the rt
#: search's; ``sphere_hits`` counts the dense entry); ``pq_scan_sort``:
#: calls of ``pq_scan.pq_scan_sort_topk`` (the scores kernel and a stable
#: sort), which ``pq_scan_topk`` takes past its kernels' limits
LAUNCHES = {name: 0 for name in SOURCES + ("sphere_probe", "pq_scan_sort")}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for one source unless its library exists already."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), target


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> str:
    proc, tmp, target = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)
    return out


def build_all() -> dict[str, str]:
    """Compile every kernel source in parallel (one ``nvcc`` each).

    Returns
    -------
    dict
        Source name -> the compiler's output (``-Xptxas -v`` register and
        shared-memory report); empty for libraries already built.
    """
    jobs = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, job) if job else ""
            for name, job in jobs.items()}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel source, built if needed."""
    job = _start(name)
    if job:
        _finish(name, job)
    return ctypes.CDLL(str(_target(name)))


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def checked(name: str, t: torch.Tensor, dtype: torch.dtype,
            shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Return ``t`` if it has this dtype, shape and device and is
    contiguous; raise ``ValueError`` otherwise."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t


def optional(name: str, t: torch.Tensor | None, dtype: torch.dtype,
             shape: tuple[int, ...], device: torch.device) -> int | None:
    """The data pointer of an optional kernel argument: ``None`` (a null
    pointer) for ``None``, else that of :func:`checked`'s tensor."""
    return None if t is None else checked(name, t, dtype, shape,
                                           device).data_ptr()


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
