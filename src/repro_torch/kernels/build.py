"""Builds the hand-written CUDA kernels in ``repro_torch/csrc`` and loads
them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc`` for ``sm_90a`` into its own shared library, under a
directory named by a hash of the source and the flags
(``build/kernels/<name>-<hash>/`` at the root of the checkout), so an
edited source rebuilds and an unchanged one is reused.  Nothing prebuilt
is committed.  A failed build raises :class:`KernelBuildError` with the
compiler's output.  :func:`launch` calls a loaded kernel on PyTorch's
current stream.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gram_sum", "fusion_conv", "compress_pack", "ef_rows",
           "flash_attn", "flash_attn_bwd", "decode_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas's register / shared-memory / spill report for each built source
BUILD_LOG: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_ROOT / f"{name}-{digest[:16]}" / f"lib{name}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together.  Returns name -> library."""
    names = tuple(names)
    libs = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not libs[n].exists()]
    if not todo:
        return libs
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        libs[n].parent.mkdir(parents=True, exist_ok=True)
        tmp = libs[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[n])   # atomic: a concurrent build is safe
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _LIBS[name] = lib
    return lib


def launch(kernel: str, fn, device: torch.device, *args) -> None:
    """Calls ``fn(*args, stream)`` on ``device``'s current stream (read on
    every call, as a raw handle: a CUDA graph captures on a side stream),
    switching devices only when ``device`` is not the current one.  A
    non-zero return (a CUDA error) raises RuntimeError."""
    index = device.index
    raw_stream = torch._C._cuda_getCurrentRawStream
    if torch.cuda.current_device() == index:
        rc = fn(*args, raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
