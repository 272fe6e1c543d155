"""Build the port's CUDA kernels and bind them with ctypes.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C entry point, under ``build/kernels/``
at the root of the checkout.  The library's file name carries a hash of
its source and flags, so an edited source is rebuilt on its next use and
an unchanged one is loaded as built.  A failed build raises with the
compiler's output; nothing falls back to the plain path.

Every entry point returns ``cudaGetLastError()`` after its launch, and
``Kernel.launch`` raises when that is not 0: a refused launch never runs,
and ``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Type codes shared by every entry point's ``dtype`` argument.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return str(path)


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: the name carries a hash of the
    source text and the compiler flags."""
    digest = hashlib.sha256((CSRC_DIR / source).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources) -> dict:
    """Compile every source in ``sources`` whose library is missing, one
    ``nvcc`` per source, all started together.  Returns {source: library
    path}; raises with the compiler's output if any build fails.  The
    ptxas report of each build is kept beside its library (``.log``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {src: library_path(src) for src in sources}
    running = []
    for src, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
        running.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in running:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)       # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


def build_all() -> dict:
    """Build every kernel source of the port (in parallel)."""
    return build(sorted(p.name for p in CSRC_DIR.glob("*.cu")))


class Kernel:
    """One CUDA entry point: built and loaded on first launch, launched on
    PyTorch's current stream, and counted.

    ``launches`` goes up by one for each launch that CUDA accepted,
    and nowhere else, so a run can show that it went through the kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + the stream
        self.launches = 0
        self._lib = None
        self._fn = None

    def _entry(self):
        if self._fn is None:
            self._lib = ctypes.CDLL(str(build([self.source])[self.source]))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raises if the launch was
        refused.  Pointer arguments are ``tensor.data_ptr()`` ints: the
        caller keeps the tensors alive until the stream has used them."""
        fn = self._entry()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} ({self.source}) launch failed with CUDA "
                f"error {err}")
        self.launches += 1


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The common CUDA device of ``tensors``; raises if any is elsewhere."""
    device = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(
                f"{name} runs on one CUDA device; got tensors on "
                f"{sorted({str(x.device) for x in tensors})}")
    return device


def dtype_code(name: str, dtype: torch.dtype, allowed) -> int:
    if dtype not in allowed:
        raise TypeError(f"{name} takes {[str(d) for d in allowed]}, "
                        f"got {dtype}")
    return DTYPE_CODES[dtype]
