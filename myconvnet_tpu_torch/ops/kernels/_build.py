"""Build and load the hand-written CUDA kernels under ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into one shared
library with a plain C interface, which ``ctypes`` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<hash>/libmcn_kernels.so csrc/*.cu

``<hash>`` covers the sources, the flags and the compiler path, so an edit
rebuilds and an unchanged tree reuses the library.  The compiler writes to
a temporary file in the same directory and ``os.replace`` moves it into
place, so processes that build at the same time never load a half-written
library.  ``build/`` sits at the root of the checkout and is git-ignored.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a non-zero code.  Pointers and the stream are passed as
``c_void_p`` (ctypes would otherwise truncate them to 32-bit ints).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
LIB_NAME = "libmcn_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64

# C entry points: name -> argtypes (restype is int, a cudaError_t)
SIGNATURES = {
    # x, a, b, y, rows, channels, act, stream
    "mcn_scale_shift_act_f32": (P, P, P, P, I64, I32, I32, P),
    "mcn_scale_shift_act_bf16": (P, P, P, P, I64, I32, I32, P),
    # x, w1, s1, b1, w3, s3, b3, y, n, h, w, cin, cm, cout, stream
    "mcn_conv_pair": (P, P, P, P, P, P, P, P,
                      I32, I32, I32, I32, I32, I32, P),
    # n, h, w, cin, cm, cout, int[4] out: TH, TW, CS, shared-memory bytes
    "mcn_conv_pair_plan": (I32, I32, I32, I32, I32, I32, P),
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                           f"({cuda_home}); the CUDA kernels need it")
    return path


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_key(nvcc: str) -> str:
    h = hashlib.sha256()
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the library unless it exists; returns (path, seconds spent
    compiling, 0.0 when it was already built)."""
    nvcc = nvcc_path()
    out_dir = BUILD_DIR / build_key(nvcc)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
