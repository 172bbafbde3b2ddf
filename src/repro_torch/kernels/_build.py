"""Builds the port's CUDA sources at first use and loads them with ctypes.

Every ``kernels/*/csrc/*.cu`` is compiled on its own by ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), under ``build/kernels/`` at the repository root, named by a
hash of the source and the flags so that an edited source is rebuilt and an
unchanged one is loaded from the cache. ``build_all`` starts one ``nvcc``
per source, all at once. Nothing here runs when the module is imported.
The checks every wrapper and dispatcher shares are here too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
# IEEE division and no fast math: the int8 codec is held bit-equal to its
# plain version, and the attention kernels' expf and divisions to theirs
# within the reference's f32 tolerances.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# What the attention and WKV kernels take: head dims and input types (the
# dtype code each source's entry point reads).
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(srcs: List[Path] | None = None) -> Dict[str, Path]:
    """Compile every source whose library is not cached, one ``nvcc`` per
    source in parallel; returns {source stem: library path}. Raises with the
    compiler's output if any build fails. The ptxas report (registers,
    shared memory, spills) goes to ``<library>.log``."""
    srcs = sources() if srcs is None else srcs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {s.stem: _target(s) for s in srcs}
    procs = []
    for s in srcs:
        lib = out[s.stem]
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(s)]
        procs.append((s, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for s, lib, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed on {s.name} (rc {p.returncode}):\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed)."""
    if stem not in _LOADED:
        src = [s for s in sources() if s.stem == stem]
        if len(src) != 1:
            raise RuntimeError(f"no unique CUDA source named {stem}.cu")
        _LOADED[stem] = ctypes.CDLL(str(build_all(src)[stem]))
    return _LOADED[stem]


def on_cuda(t: torch.Tensor, op: str) -> bool:
    """Dispatch rule of every ``ops`` module: a CUDA tensor takes the
    kernel, a CPU tensor the plain version, anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: unsupported device {t.device}")


def check_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def raise_if_failed(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t itself when its address and strides are multiples of 16 bytes, as
    the kernels' 16-byte cp.async copies need; else a contiguous copy (whose
    rows of D >= 16 elements are)."""
    es = t.element_size()
    if t.data_ptr() % 16 == 0 and all(s * es % 16 == 0
                                      for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def run_on(dev: torch.device, launch):
    """launch(stream) on dev's current PyTorch stream, with dev made the
    current CUDA device only when it is not already."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index is None or dev.index == torch.cuda.current_device():
        return launch(stream)
    with torch.cuda.device(dev):
        return launch(stream)
