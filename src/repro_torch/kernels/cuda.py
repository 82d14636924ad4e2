"""Build, load and launch bookkeeping for the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (one ``repro_<kernel>`` entry
per kernel it holds) and loaded with ``ctypes`` —
no PyTorch headers, so a build takes seconds. Libraries land in
``build/`` at the repository root, named by a hash of the flags and of the
source with the ``csrc/*.cuh`` headers it includes, so an unchanged source
is never rebuilt and an edited header rebuilds every source that includes
it. The first kernel call
builds; ``build()`` builds every source at once (one ``nvcc`` process per
source, all started together). Nothing is built at import time.

``launches`` counts kernel launches per kernel name: each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"rbf_rows": "rbf_rows.cu",
           "rbf_accumulate": "rbf_accumulate.cu",
           "ell_rows": "ell_rows.cu",
           "ell_accumulate": "ell_accumulate.cu",
           "flash_attention": "flash_attention.cu"}
KERNELS = {"gamma_update": "rbf_rows",      # kernel -> library holding it
           "rbf_rows2": "rbf_rows",
           "rbf_accumulate": "rbf_accumulate",
           "ell_kernel_row": "ell_rows",
           "ell_kernel_rows2": "ell_rows",
           "ell_gamma_update": "ell_rows",
           "ell_rbf_accumulate": "ell_accumulate",
           "flash_attention": "flash_attention"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: dict[str, int] = {name: 0 for name in KERNELS}
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build_dir() -> Path:
    """``build/`` at the repository root (src/repro_torch/kernels -> root)."""
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels need it")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _inputs(path: Path, seen: dict) -> dict:
    """``path`` and every file it includes by ``#include "..."``, directly
    or through another include, resolved beside the including file:
    ``{path: bytes}``."""
    if path in seen:
        return seen
    text = path.read_bytes()
    seen[path] = text
    for inc in _INCLUDE.findall(text):
        found = (path.parent / inc.decode()).resolve()
        if found.is_file():           # else a toolkit header on nvcc's path
            _inputs(found, seen)
    return seen


def _target(name: str) -> Path:
    """The library's path, named by a hash of the flags and of the source
    with every header it includes, so that an edit to either rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path, text in sorted(_inputs(CSRC / SOURCES[name], {}).items()):
        h.update(path.name.encode() + b"\0" + text)
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict:
    """Compile every named library whose file is missing, all ``nvcc``
    processes in parallel. Returns ``{name: {"seconds", "ptxas", "cached"}}``
    (``ptxas`` holds the compiler's register/shared-memory report). Raises
    with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    report, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        log = out.with_suffix(".log")
        if out.exists():
            report[name] = {"seconds": 0.0, "cached": True,
                            "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
        log.write_text(text)
        report[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                        "ptxas": text}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build([name])
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
    return lib


def entry(kernel: str, argtypes: list, name: "str | None" = None):
    """The C entry point ``repro_<name>`` (``name`` defaults to the
    kernel's; a kernel's second entry, such as ``rbf_rows2_cached``, lives
    in the kernel's library), which returns a cudaError_t as ``int``;
    loaded once and cached."""
    name = name or kernel
    f = _entries.get(name)
    if f is None:
        f = getattr(library(KERNELS[kernel]), f"repro_{name}")
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _entries[name] = f
    return f


def constant(kernel: str, what: str) -> int:
    """An ``int`` constant the library of ``kernel`` exports as
    ``repro_<kernel>_<what>()`` (e.g. the SV rows of an accumulate's
    chunk), read once and cached."""
    key = f"{kernel}_{what}"
    v = _entries.get(key)
    if v is None:
        f = getattr(library(KERNELS[kernel]), f"repro_{key}")
        f.argtypes = []
        f.restype = ctypes.c_int
        v = _entries[key] = int(f())
    return v


SV_DTYPES = (torch.float32, torch.bfloat16)   # stored SV values' types


def check(t: torch.Tensor, what: str, shape: tuple,
          dtype: "torch.dtype | tuple" = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (f32 by
    default; a tuple names every type taken) and ``shape``."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    taken = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in taken:
        want = " or ".join(str(d) for d in taken)
        raise TypeError(f"{what}: expected {want}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def check_ell(vals: torch.Tensor, cols: torch.Tensor,
              sq_norms: torch.Tensor,
              vals_dtype: "torch.dtype | tuple" = torch.float32) -> tuple:
    """Check a block-ELL operand triple — vals (N, K) of ``vals_dtype``
    (f32 by default), cols (N, K) int32, sq_norms (N,) f32, contiguous, on
    the card — and return ``(N, K)``."""
    if not isinstance(vals, torch.Tensor) or vals.dim() != 2:
        raise ValueError(f"vals: expected an (N, K) tensor, got "
                         f"{tuple(getattr(vals, 'shape', ()))}")
    n, K = vals.shape
    check(vals, "vals", (n, K), vals_dtype)
    check(cols, "cols", (n, K), torch.int32)
    check(sq_norms, "sq_norms", (n,))
    return n, K


def check_table(table: torch.Tensor, slot2: torch.Tensor, hit: torch.Tensor,
                m: int) -> None:
    """Check the row cache's operands of a cached two-row entry: the value
    table (S, m) f32, the two slots (2,) int32 and the hit flag, a 0-d
    int32, contiguous and on the card. The slots' range is the cache's to
    keep (they come from a search over its S tags)."""
    if not isinstance(table, torch.Tensor) or table.dim() != 2:
        raise ValueError(f"table: expected an (S, {m}) tensor, got "
                         f"{tuple(getattr(table, 'shape', ()))}")
    check(table, "table", (table.shape[0], m))
    check(slot2, "slot2", (2,), torch.int32)
    check(hit, "hit", (), torch.int32)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
