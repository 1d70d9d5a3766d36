"""Build and bind the port's CUDA kernels.

Every ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o _build/<name>-<hash>.so csrc/<name>.cu

A source whose bodies are templated on a padded head width also builds at
its other widths, one library ``<name>_w<W>`` each, with
``-D<macro>=W`` (:data:`WIDTH_LIBRARIES`), so that the widths compile in
parallel.

and is loaded with ``ctypes``; the compiler's output, with ptxas's report of
each kernel's registers and spills, is kept beside it as
``<name>-<hash>.log``.  ``<hash>`` covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one loads the library it already built.  Nothing
here runs at import time: the CPU tests import the package on machines
with no ``nvcc``.  :func:`build_all` starts one ``nvcc``
per source, all at once, and waits for them together (each one's output
goes to its log file as it compiles, and ``BUILD_SECONDS`` keeps when each
library was done).

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
import time
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "DTYPE_CODE", "BUILD_SECONDS",
           "WIDTH_LIBRARIES", "build_all", "library", "width_library",
           "on_card", "launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# the kernels' dtype codes for q / x / out
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# source -> (its width macro, the head widths of its own library (the
# macro's default in the source), the widths built as ``<source>_w<W>``)
WIDTH_LIBRARIES = {
    "flash_attention": ("FA_TU_WIDTHS", (64, 128),
                        (32, 48, 80, 96, 160, 192, 256)),
    "ragged_paged_attention": ("RPA_TU_WIDTHS", (64, 128),
                               (32, 96, 160, 192, 256)),
    "ragged_paged_attention_quant": ("RPA_TU_WIDTHS", (64, 128),
                                     (32, 96, 160, 192, 256)),
}

_LIBS: dict[str, ctypes.CDLL] = {}
# seconds from the start of the last build_all to each library it built
BUILD_SECONDS: dict[str, float] = {}


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


def width_library(source: str, width: int) -> str:
    """The library of ``source`` (a key of :data:`WIDTH_LIBRARIES`) that
    holds head width ``width``."""
    _, own, more = WIDTH_LIBRARIES[source]
    if width in own:
        return source
    if width in more:
        return f"{source}_w{width}"
    raise ValueError(f"{source} is not built at head width {width}")


def _sources(csrc: Path) -> dict[str, tuple[str, tuple[str, ...]]]:
    """{library name: (source stem, its -D flags)} of every library that
    the sources of ``csrc`` build."""
    out = {p.stem: (p.stem, ()) for p in csrc.glob("*.cu")}
    for src, (macro, _, more) in WIDTH_LIBRARIES.items():
        if src in out:
            out.update({f"{src}_w{w}": (src, (f"-D{macro}={w}",))
                        for w in more})
    return out


def _target(name: str, src_name: str, flags, csrc: Path) -> Path:
    src = (csrc / f"{src_name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=None, defines=(), csrc=CSRC) -> dict[str, Path]:
    """Compile every named library (default: all that ``csrc/*.cu`` and
    :data:`WIDTH_LIBRARIES` make) that is missing — one ``nvcc`` process
    per library, started together — and return ``{name: library path}``.  ``defines`` (``-DNAME=value``
    flags) build a variant of the sources' compile-time settings, and
    ``csrc`` another directory's sources (another commit's, for timing
    against them), into libraries of their own; the port loads the default
    build.  Raises with the compiler's output when any build fails."""
    sources = _sources(csrc)
    if names is None:
        names = sorted(sources)
    flags = {n: (*NVCC_FLAGS, *sources[n][1], *defines) for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n, sources[n][0], flags[n], csrc) for n in names}
    procs = {}
    start = time.perf_counter()
    for n, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        # the compiler's output goes to a file: a pipe that nobody reads
        # until the sources before it are done would stall this build
        out = open(so.with_suffix(f".log.tmp{os.getpid()}"), "w")
        procs[n] = (subprocess.Popen(
            [_nvcc(), *flags[n], "-o", str(tmp),
             str(csrc / f"{sources[n][0]}.cu")],
            stdout=out, stderr=subprocess.STDOUT), tmp, out)
    failed = []
    while procs:
        for n in [n for n, (p, _, _) in procs.items() if p.poll() is not None]:
            proc, tmp, out = procs.pop(n)
            BUILD_SECONDS[n] = time.perf_counter() - start
            out.close()
            log_tmp = Path(out.name)
            log = log_tmp.read_text()
            if proc.returncode != 0:
                failed.append(f"{n} (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                log_tmp.unlink(missing_ok=True)
            else:
                os.replace(log_tmp, targets[n].with_suffix(".log"))
                os.replace(tmp, targets[n])
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (of ``csrc/<name>.cu``, or a width of a
    source of :data:`WIDTH_LIBRARIES`), built first if needed."""
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
    """Call the C entry ``fn_name`` of the library ``lib_name`` with ``args``
    and the current stream of ``device``; raise if it returns a CUDA
    error."""
    fn = getattr(library(lib_name), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
