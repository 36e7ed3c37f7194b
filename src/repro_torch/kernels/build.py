"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/*.cu`` source compiles on first use into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

The libraries go to ``build/repro_torch_kernels/`` at the repository root,
named by a hash of the sources and flags, so an edited source never loads a
stale library. :func:`build` compiles several sources at once, one ``nvcc``
process each, and returns the compiler's ``-Xptxas -v`` report (registers,
shared memory, spills) per source.

A kernel's Python wrapper holds a :class:`CudaKernel`: it launches on
PyTorch's current stream, raises when the launcher returns a CUDA error, and
counts its launches in ``launches``, a plain integer (and per launcher
symbol in ``symbol_launches``). A call made while a CUDA graph captures
records the launch instead of making it; the graph's owner takes that count
back and adds it on every replay (``kernels.ops.add_launches``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Sequence, Union

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("topk_gate.cu", "moe_gmm.cu", "decode_attention.cu", "flash_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """Path of the CUDA compiler (``PATH`` first, then the toolkit's default)."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's kernels build only where the CUDA toolkit is")


def library_path(source: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / source).read_bytes())
    h.update((CSRC / "common.cuh").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source of ``sources`` whose library is missing, all at
    once, and wait for them. Returns ``{source: ptxas report}``; a source
    already built reports the log kept beside its library. Raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    logs: Dict[str, str] = {}
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            log = lib.with_suffix(".log")
            logs[src] = log.read_text() if log.exists() else ""
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src}:\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
        logs[src] = out
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return logs


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (built first if missing)."""
    lib = library_path(source)
    if not lib.exists():
        build([source])
    cdll = ctypes.CDLL(str(lib))
    cdll.repro_error_name.argtypes = [ctypes.c_int]
    cdll.repro_error_name.restype = ctypes.c_char_p
    return cdll


class CudaKernel:
    """One kernel's C launchers (one symbol per element type or entry) in
    ``source``, with one launch count over all of them (``launches``) and
    one per symbol beside it (``symbol_launches``).

    ``argtypes`` lists a launcher's arguments without the trailing stream:
    ``ctypes.c_void_p`` for every pointer, ``ctypes.c_int`` / ``c_float`` for
    scalars (an undeclared pointer would be cut to 32 bits); a mapping gives
    each symbol its own list."""

    def __init__(self, name: str, source: str, argtypes: Union[Sequence, Mapping[str, Sequence]]):
        self.name = name
        self.source = source
        self.argtypes = argtypes
        self._fns: Dict[str, ctypes._CFuncPtr] = {}
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.symbol_launches: Dict[str, int] = {}

    def __call__(self, symbol: str, device, *args) -> None:
        import torch

        fn = self._fns.get(symbol)
        if fn is None:
            fn = getattr(load(self.source), symbol)
            types = self.argtypes[symbol] if isinstance(self.argtypes, Mapping) else self.argtypes
            fn.argtypes = list(types) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn
        if device.index in (None, torch.cuda.current_device()):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(device):
                rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            name = load(self.source).repro_error_name(rc).decode()
            raise RuntimeError(f"{self.name}: launch failed with CUDA error {rc} ({name})")
        self.count(symbol)

    def count(self, symbol: str, n: int = 1) -> None:
        """Count ``n`` launches of ``symbol``: one per wrapper call, or a CUDA
        graph's replay of the launches its capture recorded."""
        self.launches += n
        self.symbol_launches[symbol] = self.symbol_launches.get(symbol, 0) + n
