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
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: Never -use_fast_math: the KV writer's int8 quantizer
#: (csrc/kv_write.cu) must keep IEEE division to stay bit-identical to the
#: plain quantizer.
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

#: torch dtype -> the ``AikoDtype`` code of csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C entry points and their argument types (see each .cu's extern "C").
SIGNATURES = {
    "aiko_int8_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "aiko_int4_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    "aiko_int4_matmul_tiled": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _P],
    "aiko_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "aiko_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                             _I, _I, _F, _P],
    "aiko_append_kv": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "aiko_append_kv_ragged": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "aiko_write_kv_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _L, _L, _I, _I, _I, _P],
    "aiko_ring_ag_step": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "aiko_ring_rs_step": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    # No stream: a rank's split scratch, and what the two steps above take
    # for these arguments (written into the last, an int[3]).
    "aiko_ring_scratch_floats": [_I],
    "aiko_ring_ag_plan": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "aiko_ring_rs_plan": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "aiko_chunk_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                             _I, _P],
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


def _record_build(target: pathlib.Path, hit: bool, wall_ms: float,
                  saved_ms: float = 0.0) -> None:
    """Book a lookup of the library with the compile ledger's cache
    counters (obs/compiles.py): found built (a hit) or built (a miss)."""
    from ..obs import compiles
    compiles.record_kernel_build(target.name, hit, wall_ms, saved_ms)


def build() -> pathlib.Path:
    """Compile every source in parallel and link the shared library (a
    no-op when the library for these sources already exists: the digest
    names the sources and flags, so the library found is theirs).  The
    build's wall ms is kept beside the library; a later lookup that finds
    it books that time as saved."""
    began = time.perf_counter()
    target = library_path()
    timing = target.with_name(target.name + ".ms")
    if target.exists():
        lookup_ms = (time.perf_counter() - began) * 1e3
        try:
            built_ms = float(timing.read_text())
        except (OSError, ValueError):
            built_ms = lookup_ms
        _record_build(target, True, lookup_ms, built_ms - lookup_ms)
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
    built_ms = (time.perf_counter() - began) * 1e3
    try:
        timing.write_text(f"{built_ms:.1f}")
    except OSError:
        pass
    _record_build(target, False, built_ms)
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


def entry(name: str):
    """The bound C entry ``name`` (its last argument is the stream, but
    for the ring's scratch and plan queries)."""
    return getattr(library(), name)


def raise_error(name: str, code: int) -> None:
    message = library().aiko_error_string(code).decode()
    raise RuntimeError(f"{name}: CUDA error {code} ({message})")


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` on ``device``'s current stream; raise if its
    launch was refused."""
    # The raw handle: building a torch.cuda.Stream object per launch costs
    # more host time than the smaller kernels take on the card.
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    code = entry(name)(*args, stream)
    if code:
        raise_error(name, code)


#: Per-device scratch of the kernels that split work across CTAs: f32
#: partial results and int32 arrival counters.  Launches on one stream run
#: in order, each consumes its partials before the next starts and leaves
#: the counters zero, so one grow-only pair serves every launch.  A CUDA
#: graph keeps the pair it captured (:func:`scratch_buffers`): a later
#: growth replaces the pair here, never under a graph.
_SCRATCH: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def scratch(device: torch.device, floats: int,
            counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    partials, arrivals = _SCRATCH.get(device, (None, None))
    grow_partials = partials is None or partials.numel() < floats
    grow_arrivals = arrivals is None or arrivals.numel() < counters
    if (grow_partials or grow_arrivals) \
            and torch.device(device).type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"kernel scratch on {device} would grow to {floats} floats and "
            f"{counters} counters while a CUDA graph is captured: run the "
            "captured work once eagerly first, which sizes it")
    if grow_partials:
        partials = torch.empty(max(floats, 1 << 20), dtype=torch.float32,
                               device=device)
    if grow_arrivals:
        arrivals = torch.zeros(max(counters, 4096), dtype=torch.int32,
                               device=device)
    _SCRATCH[device] = (partials, arrivals)
    return partials, arrivals


def scratch_buffers(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The scratch pair now in use on ``device`` (empty before the first
    launch that needs one): what a graph captured holds on to.  A card
    named without its index is the current one, as a tensor's is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _SCRATCH.get(device, ())


#: Every kernel wrapper with a ``.launches`` counter, which it bumps where
#: it launches its kernel (:func:`counted`).
COUNTED: List = []


def counted(wrapper):
    """Give kernel wrapper ``wrapper`` its launch counter (0) and register
    it, so that a CUDA graph can count what a replay launches
    (:func:`launch_counts`, :func:`take_back`, :func:`add_launches`)."""
    wrapper.launches = 0
    COUNTED.append(wrapper)
    return wrapper


def launch_counts() -> Dict:
    """Every registered wrapper's counter now."""
    return {wrapper: wrapper.launches for wrapper in COUNTED}


def take_back(before: Dict) -> Dict:
    """Reset every counter to ``before`` (taken by :func:`launch_counts`)
    and return what each gained since: a capture runs the wrappers'
    Python, whose increments the capture itself never launches."""
    delta = {}
    for wrapper, count in before.items():
        if wrapper.launches != count:
            delta[wrapper] = wrapper.launches - count
            wrapper.launches = count
    return delta


def add_launches(delta: Dict) -> None:
    """Count one replay of a graph whose capture gained ``delta``."""
    for wrapper, count in delta.items():
        wrapper.launches += count


def capture_graph(program: Callable[[], Any], device: torch.device,
                  stream: Optional[torch.cuda.Stream] = None) -> Tuple:
    """Capture ``program()`` as one CUDA graph on ``stream`` (None:
    ``torch.cuda.graph``'s own side stream).  Run it eagerly once before:
    that sizes the kernels' scratch and makes what a capture may not make.
    Returns (graph, outputs, launches a replay, scratch held): the counts
    the capture gained are taken back, for :func:`add_launches` to add on
    every replay, and the scratch pair the graph writes stays referenced
    while the tuple is kept, so a caller that grows the scratch later
    frees no memory a replay writes.  A capture that fails raises."""
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=stream):
            outputs = program()
    finally:
        launches = take_back(before)
    return graph, outputs, launches, scratch_buffers(device)


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
