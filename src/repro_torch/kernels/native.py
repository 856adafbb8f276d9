"""Build, load and count the hand-written CUDA kernels.

The sources live in ``repro_torch/csrc/*.cu`` (the headers they share in
``csrc/*.cuh``), each with a plain C interface. At first use every
missing library is compiled by its own ``nvcc`` process (all started
together) into ``repro_torch/_build/``, under a name keyed by a hash of
the source, its headers and the flags, and loaded with ``ctypes`` — so a
checkout builds its kernels on first call and a second run reuses them.
Nothing here runs at import: the CPU tests import every module without
``nvcc`` or a card.

Every wrapper adds to ``LAUNCHES[name]`` the launches its C entry point
reports (one, or one per 64 leaves of a leaf table) where it launches its
kernel and nowhere else, so a run can show that it went through the
kernels.

Every wrapper is also a kernel entry (:func:`kernel_entry`): it reports
one :class:`KernelRecord` (its kernel's name, the bytes of its tensor
operands and outputs, the launches) to each active recorder
(``launch.cost_model.structural_costs``) where it launches its kernel,
where it runs the plain version on a CPU tensor, and where it answers a
``meta`` tensor with empty ``meta`` outputs of the kernel's shapes. While
an entry runs, the aten operations inside it and the entries it calls
are not counted again: a kernel's HBM traffic is its operand and output
buffers, as the reference's cost model counts a ``pallas_call``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("quantize_pack", "dequant_mix", "momentum_sgd", "threefry")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 600
_INCLUDE = re.compile(r'^#include "([^"]+)"', re.MULTILINE)

KERNELS = ("quantize_pack_buffer", "dequant_mix_buffer", "momentum_sgd",
           "momentum_quantize_pack_buffer", "dequant_mix_momentum_buffer",
           "quantize_pack", "dequant_mix_plan", "dequant_mix",
           "threefry_split", "threefry_uniform", "threefry_bits",
           "threefry_normal", "momentum_sgd_lanes")
LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}

# The active byte recorders (callables taking a KernelRecord) and the
# depth of nested kernel entries on the stack.
RECORDERS: list = []
_DEPTH = [0]

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): under
    ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``), else on PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if cand.is_file():
        return str(cand)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found: set CUDA_HOME or put the "
                           "CUDA toolkit's bin on PATH")
    return found


def lib_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: keyed by
    the source bytes, the bytes of every header of ``csrc/`` it includes
    (``#include "x.cuh"``) and the compiler flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src)
    for header in _INCLUDE.findall(src.decode()):
        h.update((CSRC_DIR / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all in parallel. Returns the wall seconds each
    compile took (sources already built are left out). Raises with the
    compiler's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running, seconds, errors = {}, {}, []
    try:
        for name in names:
            out = lib_path(name)
            if out.exists():
                continue
            nvcc = nvcc or cuda_tool("nvcc")
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running[name] = (proc, tmp, out, time.perf_counter())
        for name, (proc, tmp, out, t0) in running.items():
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {name}.cu "
                              f"(rc={proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, out)
            seconds[name] = time.perf_counter() - t0
    finally:
        for proc, tmp, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def function(lib: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``lib`` (built on first
    use), with its argument types declared. Every entry point returns the
    ``cudaError_t`` of its launch as an int."""
    key = (lib, symbol)
    if key not in _FUNCS:
        if lib not in _LIBS:
            build((lib,))
            _LIBS[lib] = ctypes.CDLL(str(lib_path(lib)))
        fn = getattr(_LIBS[lib], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return _FUNCS[key]


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(rc: int, kernel: str, launches: int = 1) -> None:
    """Raise if the launch failed; count the ``launches`` the entry point
    made if it did not."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
    LAUNCHES[kernel] += launches


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple | None = None, device=None) -> None:
    """Validate a kernel operand before its pointer goes to C."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_aligned(t: torch.Tensor, name: str) -> None:
    """A kernel that moves 16 bytes a thread needs its operand to start on
    a 16-byte boundary (its rows follow, W being a multiple of 512)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


@dataclasses.dataclass(frozen=True)
class KernelRecord:
    """One kernel entry's call: its kernel (a ``LAUNCHES`` key), the
    bytes of its tensor operands and of its outputs (scalars passed by
    value and host tables are not HBM traffic), and its launches."""

    name: str
    operand_bytes: int
    output_bytes: int
    launches: int

    @property
    def bytes(self) -> int:
        return self.operand_bytes + self.output_bytes


def nbytes(*ts) -> int:
    """Bytes of the tensors given (None skipped)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def kernel_entry(fn):
    """Mark ``fn`` as a kernel entry: while it runs, recorders skip the
    aten operations it makes and the records of entries it calls."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        _DEPTH[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _DEPTH[0] -= 1
    return entry


def in_kernel_entry() -> bool:
    """Whether a kernel entry is running on this thread (a plain version called
    inside another entry reports nothing of its own)."""
    return _DEPTH[0] > 0


def report(kernel: str, operands, outputs, launches: int = 1) -> None:
    """Give every active recorder the record of one call of ``kernel``
    (only the outermost entry's: a plain version that calls another
    entry reports once)."""
    if RECORDERS and _DEPTH[0] <= 1:
        rec = KernelRecord(kernel, nbytes(*operands), nbytes(*outputs),
                           launches)
        for r in RECORDERS:
            r(rec)


def is_meta(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the ``meta`` device (an entry then returns empty
    ``meta`` outputs and does no arithmetic)."""
    return t.device.type == "meta"
