"""Build and bind the port's hand-written CUDA kernels.

Every ``aiko_services_tpu_torch/csrc/*.cu`` source is compiled by ``nvcc``
for ``sm_90a`` (one ``nvcc`` per source, all started together) and linked
into ONE shared library with a plain C interface, at first use, under
``aiko_services_tpu_torch/_build/``.  The library is named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once.  It is loaded with :mod:`ctypes`: pointers and the stream
are ``c_void_p``, and each C entry returns the ``cudaGetLastError()`` code
of its launch, which :func:`launch` turns into an exception.

Nothing here runs at import: the CPU tests import every module of the port
on a machine with neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: Never -use_fast_math: the append kernels' int8 KV quantizer
#: (csrc/kv_write.cuh) must keep IEEE division to stay bit-identical to the
#: plain quantizer.
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

#: torch dtype -> the ``AikoDtype`` code of csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C entry points and their argument types (see each .cu's extern "C").
SIGNATURES = {
    "aiko_int8_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "aiko_int4_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    "aiko_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "aiko_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                             _I, _I, _F, _P],
    "aiko_append_kv": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "aiko_append_kv_ragged": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "aiko_chunk_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                             _P],
}

_LOCK = threading.Lock()
_LIBRARY: Optional[ctypes.CDLL] = None
#: nvcc's per-source output (``-Xptxas -v`` register/spill report) of the
#: build this process ran; empty when the library was already built.
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _sources() -> List[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> pathlib.Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(COMPILE_FLAGS).encode())
    return BUILD_DIR / f"libaiko_kernels_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile every source in parallel and link the shared library (a
    no-op when the library for these sources already exists)."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        jobs = []
        for source in _sources():
            obj = pathlib.Path(work) / (source.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-I", str(CSRC_DIR), "-c",
                   str(source), "-o", str(obj)]
            jobs.append((source, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for source, _, proc in jobs:
            output, _ = proc.communicate()
            BUILD_LOG[source.name] = output
            if proc.returncode:
                failed.append(f"{source.name}:\n{output}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        staged = pathlib.Path(work) / target.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged),
             *[str(obj) for _, obj, _ in jobs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(staged, target)   # atomic: concurrent builders agree
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.aiko_error_string.argtypes = [ctypes.c_int]
            lib.aiko_error_string.restype = ctypes.c_char_p
            _LIBRARY = lib
    return _LIBRARY


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` on ``device``'s current stream; raise if its
    launch was refused."""
    lib = library()
    # The raw handle: building a torch.cuda.Stream object per launch costs
    # more host time than the smaller kernels take on the card.
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    code = getattr(lib, name)(*args, stream)
    if code:
        message = lib.aiko_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({message})")


#: Per-device scratch of the kernels that split work across CTAs: f32
#: partial results and int32 arrival counters.  Launches on one stream run
#: in order, each consumes its partials before the next starts and leaves
#: the counters zero, so one grow-only pair serves every launch.
_SCRATCH: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def scratch(device: torch.device, floats: int,
            counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    partials, arrivals = _SCRATCH.get(device, (None, None))
    if partials is None or partials.numel() < floats:
        partials = torch.empty(max(floats, 1 << 20), dtype=torch.float32,
                               device=device)
    if arrivals is None or arrivals.numel() < counters:
        arrivals = torch.zeros(max(counters, 4096), dtype=torch.int32,
                               device=device)
    _SCRATCH[device] = (partials, arrivals)
    return partials, arrivals


def ptr(tensor: Optional[torch.Tensor]) -> Optional[int]:
    return None if tensor is None else tensor.data_ptr()


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device, contiguous, 16-byte aligned;
    returns that device."""
    device = tensors[0].device
    for tensor in tensors:
        if tensor.device != device:
            raise ValueError(f"{name}: tensors on {tensor.device} and "
                             f"{device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name}: tensor of shape "
                             f"{tuple(tensor.shape)} is not contiguous")
        if tensor.data_ptr() % 16:
            raise ValueError(f"{name}: tensor is not 16-byte aligned")
    return device
