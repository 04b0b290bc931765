"""Build and bind the CUDA kernels (nvcc → shared library → ctypes).

Each source `csrc/<name>.cu` is compiled by its own `nvcc` for `sm_90a`
into `build/repro_torch_kernels/lib<name>-<digest>.so` at the repository
root, on first use; the digest covers the source, every shared header, the
generated headers and the flags, so an edited source is rebuilt and a
stale library is never loaded. `build()` first writes the headers
generated from Python (`GENERATED`: `ell_plans.h`, the gather plans of
`gather_plan`) into `build/repro_torch_kernels/include`, then starts one
`nvcc` per source, all at once. The libraries
have a plain C interface (no PyTorch headers, so a build takes seconds):
pointers and the stream go in as `c_void_p`, sizes as `c_int`, and each
entry point returns `cudaGetLastError()`.

Flags are per source (`flags`). The six PageRank kernels build with
`--fmad=false`, so that their f64 arithmetic rounds as the plain PyTorch
ops do (their bars against the plain versions are 1e-12 or exact);
`flash_attention` builds without it: its scalar kernel's loops are f32
multiply-add chains held to 2e-5, and splitting each FMA would cost it
about half its throughput (its tensor-core kernel needs no flag beyond
`sm_90a`: the tensor maps are encoded through the runtime's driver entry
point, so nothing links libcuda). `flash_attention_bwd` builds without it
too, for the same reason: its scalar kernels' five products are f32
multiply-add chains, held to 1e-4 of the gradient's max against the plain
backward, whose sums run in another order anyway (its tensor-core kernels
run their products in `wgmma`).

A missing `nvcc` or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

from . import gather_plan

__all__ = ["SOURCES", "BUILD_DIR", "flags", "build",
           "load", "check", "check_out", "stream_ptr", "launch_error"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
# headers generated from Python, on the include path of every build
GEN_DIR = BUILD_DIR / "include"
GENERATED = {"ell_plans.h": gather_plan.header}
SOURCES = ("fused_ell_update", "csr_block_pull", "pr_update", "scatter_rows",
           "ell_pull", "linf_delta", "flash_attention", "flash_attention_bwd")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# sources built with FMA contraction (without --fmad=false)
FMAD = ("flash_attention", "flash_attention_bwd")

P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: PATH first, then $CUDA_HOME, then the
    toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def flags(name: str) -> tuple:
    """The nvcc flags of source `name`."""
    if name in FMAD:
        return tuple(f for f in FLAGS if f != "--fmad=false")
    return FLAGS


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    for text in GENERATED.values():
        h.update(text().encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library that is not built yet, one `nvcc` per source,
    all started together. Returns the compiler's output (register and
    shared-memory use from `-Xptxas -v`) by name; raises on any failure."""
    todo = [n for n in names if not lib_path(n).is_file()]
    if not todo:
        return {}
    GEN_DIR.mkdir(parents=True, exist_ok=True)
    for fname, text in GENERATED.items():
        tmp = GEN_DIR / f"{fname}.{os.getpid()}.tmp"
        tmp.write_text(text())
        os.replace(tmp, GEN_DIR / fname)
    cc = nvcc()
    procs = {}
    for name in todo:
        tmp = lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [cc, *flags(name), "-I", str(GEN_DIR), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, lib_path(name))
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library `name` (built first if needed), with argtypes set
    from `signatures` (entry point -> argument types; every entry point
    returns a C int)."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, args in signatures.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device`, its data aligned to its element size — the only tensors the
    kernels take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % t.element_size():
        raise ValueError(f"{name}: misaligned (data at byte "
                         f"{t.data_ptr() % t.element_size()} of an element)")


def check_out(name: str, t: torch.Tensor, dtype: torch.dtype, n: int,
              device: torch.device) -> None:
    """`check` for an output written in place at row ids below `n`: a
    vector of at least `n` elements."""
    if t.dim() != 1 or t.shape[0] < n:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected at "
                         f"least ({n},)")
    check(name, t, dtype, tuple(t.shape), device)


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on `device`, as the C interface takes it."""
    return torch.cuda.current_stream(device).cuda_stream


def launch_error(kernel: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
