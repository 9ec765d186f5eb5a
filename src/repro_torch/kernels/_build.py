"""Build, load and call the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root and loaded with ``ctypes``; a
source that includes no PyTorch header builds in seconds. The library's
file name carries a hash of the source and the flags, so an edited source
is never served from an old build. :func:`build` starts one ``nvcc`` per
source, all at once.

Flags: no ``--use_fast_math`` and no ``-ftz=true``. The engines floor
beliefs at the smallest normal float32 and must not see subnormals
flushed, and the belief softmax must use the accurate ``expf``.

This module also holds what every wrapper does around a launch: check the
tensors it hands over as raw pointers, and raise on the status the C entry
returns (``cudaGetLastError()`` right after the launch).
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

import torch

__all__ = ["KERNELS", "BUILD_DIR", "Built", "build", "function",
           "check_status", "check_arg"]

KERNELS = ("edge_scatter", "social_innov", "byz_trim", "attn_decode",
           "swa_prefill", "wkv6", "trimmed_mean")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class Built:
    """One compiled kernel library: its path, the build's wall seconds
    (0.0 when an identical build was already on disk) and nvcc's output,
    which holds ptxas' register and spill report (kept beside the library
    and read back for a build already on disk)."""

    name: str
    path: Path
    seconds: float
    log: str


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc was not found: the CUDA kernels cannot be "
                           "built on this machine")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, Built]:
    """Compile the named kernels, one ``nvcc`` process each, concurrently.
    Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done, procs = {}, {}
    for name in names:
        out = _target(name)
        if out.exists():
            log = out.with_suffix(".log")
            done[name] = Built(name, out, 0.0,
                               log.read_text() if log.exists() else "")
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        done[name] = Built(name, out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def function(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of kernel library ``name``, built and loaded
    at first use, with its argument types declared."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name].path))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_status(name: str, code: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if code != 0:
        msg = _LIBS[name].cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")


def check_arg(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple,
              device: torch.device) -> None:
    """A tensor handed to a kernel as a raw pointer: right device, dtype,
    shape, and contiguous."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
