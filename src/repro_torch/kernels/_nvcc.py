"""Build and load of the port's CUDA sources (``repro_torch/csrc/*.cu``).

Each source builds with ``nvcc`` for ``sm_90a`` into a shared library of
its own under ``repro_torch/_build/``, at first use, with its own flags:
the rail-sweep kernels keep ``--fmad=false`` (bit-identity with numpy),
the attention kernels build with FMA contraction on (they are held by
tolerance).  A library is named by the digest of its source and flags,
so an edited source or flag set builds anew, and is written under a
temporary name and moved into place, so a reader never sees a
half-written file.  Each library exposes a plain C interface and is
loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
#: flags every source builds with; a library adds its own after these
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built from source at first use")


class CudaLibrary:
    """One ``.cu`` source, its flags, and the loaded library.

    ``declare`` sets the argument and return types of the library's
    entry points once it is loaded.  :meth:`load` is thread-safe and
    builds at most once per process.
    """

    def __init__(self, source: Path, flags: tuple[str, ...],
                 declare: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self.flags = tuple(flags)
        self._declare = declare
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Where the library for this source and these flags lives."""
        digest = hashlib.blake2b(
            self.source.read_bytes() + " ".join(self.flags).encode(),
            digest_size=8).hexdigest()
        return BUILD_DIR / f"{self.source.stem}_{digest}.so"

    def build(self) -> Path:
        """Compile the source (once per source content and flags) and
        return the library's path."""
        lib = self.path()
        if lib.exists():
            return lib
        compiler = nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / (f".{lib.name}.{os.getpid()}."
                           f"{threading.get_ident()}.tmp")
        cmd = [compiler, *self.flags, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        return lib

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library, declaring its entry
        points."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
            return self._lib


def stream_of(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {err})")


def refuse_grad(name: str, tensors: dict) -> None:
    """Raise when autograd is on and an input of a kernel that has no
    backward requires a gradient: the kernel's output would carry none
    (the plain versions on the CPU differentiate as PyTorch does)."""
    import torch

    if not torch.is_grad_enabled():
        return
    for key, t in tensors.items():
        if t.requires_grad:
            raise RuntimeError(f"{name}: {key} requires grad, but the "
                               "kernel has no backward; call it under "
                               "torch.no_grad() or detach the input")
