"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc`` process,
all started together (a ``csrc/*.cuh`` header is included by the sources
that need it), and the objects are linked into one shared library with a
plain C interface that is loaded through :mod:`ctypes`.  The library
lands in ``build/repro_torch/<hash>/`` at the root of the checkout, keyed by
a hash of the sources, so the first call in a fresh checkout builds it and
every later call (and process) reuses it.

Nothing here runs at import: :func:`library` builds on first use, so the
package imports on machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(ctypes.c_int64)
_IP = ctypes.POINTER(ctypes.c_int)

#: C entry points and their argument types (every one returns cudaError_t)
SIGNATURES = {
    "repro_flash_prefill_bf16": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I64P, _I, _F, _P,
    ),
    "repro_flash_kernel_info": (_I, _IP, _IP, _IP, _IP),
    "repro_decode_attention_f32cache": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I64P, _F, _P, _I64, _P, _I64, _P,
    ),
    "repro_paged_decode_attention_f32": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I64P, _F, _P, _I64, _P,
        _I64, _P,
    ),
    "repro_decode_kernel_info": (_I, _IP, _IP, _IP, _IP),
    "repro_decode_span": (),
    "repro_quant_paged_decode_attention": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I64P, _F, _P, _I64, _P,
    ),
    "repro_quant_paged_kernel_info": (_I, _IP, _IP, _IP, _IP),
    "repro_quant_paged_span": (),
    "repro_bootstrap_partials": (
        _P, _I, _I, _I, _I, _U, _U, _P, _I64, _P, _I64, _P, _P, _P,
    ),
    "repro_bootstrap_partials_geometry": (_IP, _IP, _IP, _IP),
    "repro_bootstrap_tile_rows": (),
    "repro_bootstrap_kernel_info": (_I, _IP, _IP, _IP, _IP),
    "repro_bootstrap_means": (_P, _I, _I, _U, _P, _P, _P, _P),
    "repro_bertscore_pr": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "repro_bertscore_kernel_info": (_I, _IP, _IP, _IP, _IP),
    "repro_ssd_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I64P, _P,
        _I64, _P,
    ),
    "repro_ssd_kernel_info": (_I, _IP, _IP, _IP, _IP),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; returns
    the library's path.  The library is written last, so a directory
    without one is an interrupted build and is compiled again."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for src, _, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib)]
    link += [str(obj) for _, obj, _ in procs]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def int64_array(values: tuple[int, ...] | list[int]) -> ctypes.Array:
    return (ctypes.c_int64 * len(values))(*values)


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """The checks every kernel wrapper makes before passing a pointer."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have unit stride on its last axis")
