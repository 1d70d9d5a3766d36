"""Build and bind the port's CUDA kernels.

Every ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o _build/<name>-<hash>.so csrc/<name>.cu

and is loaded with ``ctypes``; the compiler's output, with ptxas's report of
each kernel's registers and spills, is kept beside it as
``<name>-<hash>.log``.  ``<hash>`` covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one loads the library it already built.  Nothing
here runs at import time: the CPU tests import the package on machines
with no ``nvcc``.  :func:`build_all` starts one ``nvcc``
per source, all at once, and waits for them together.

Every C entry takes the caller's CUDA stream as its last argument and
returns ``cudaGetLastError()``; :func:`launch` passes the stream and raises
on an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "DTYPE_CODE", "build_all",
           "library", "on_card", "launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# the kernels' dtype codes for q / x / out
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str, flags, csrc: Path) -> Path:
    src = (csrc / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=None, defines=(), csrc=CSRC) -> dict[str, Path]:
    """Compile every named source (default: all of ``csrc/*.cu``) whose
    library is missing — one ``nvcc`` process per source, started together
    — and return ``{name: library path}``.  ``defines`` (``-DNAME=value``
    flags) build a variant of the sources' compile-time settings, and
    ``csrc`` another directory's sources (another commit's, for timing
    against them), into libraries of their own; the port loads the default
    build.  Raises with the compiler's output when any build fails."""
    if names is None:
        names = sorted(p.stem for p in csrc.glob("*.cu"))
    flags = (*NVCC_FLAGS, *defines)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n, flags, csrc) for n in names}
    procs = {}
    for n, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        procs[n] = (subprocess.Popen(
            [_nvcc(), *flags, "-o", str(tmp), str(csrc / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            targets[n].with_suffix(".log").write_text(log)
            os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]))
    return lib


def on_card(name: str, x) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{x.device}")
    return x.device.type == "cuda"


def launch(lib_name: str, fn_name: str, argtypes, args, device) -> None:
    """Call the C entry ``fn_name`` of ``csrc/<lib_name>.cu`` with ``args``
    and the current stream of ``device``; raise if it returns a CUDA
    error."""
    fn = getattr(library(lib_name), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
