"""Build and load the hand-written CUDA kernels under ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into an object, one
process per source, all started together, then links the objects into one
shared library with a plain C interface, which ``ctypes`` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu      (each source)
    nvcc -shared -o build/kernels/<hash>/libmcn_kernels.so *.o

``<hash>`` covers the sources, the headers they share (``*.cuh``), the
flags and the compiler path, so an edit rebuilds and an unchanged tree
reuses the library.  The compiler writes
into a temporary directory beside it and ``os.replace`` moves the library
into place, so processes that build at the same time never load a
half-written library.  ``build/`` sits at the root of the checkout and is
git-ignored.

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
              "-O3", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
F32 = ctypes.c_float
STRIDES = ctypes.POINTER(ctypes.c_longlong)

# C entry points: name -> argtypes (restype is int, a cudaError_t)
SIGNATURES = {
    # x, a, b, y, rows, channels, act, path (0 scalar, 1 vectors with a
    # channel index each, 2 a fixed channel group a thread), threads,
    # blocks (bn_act.plan's), stream
    "mcn_scale_shift_act_f32": (P, P, P, P, I64, I32, I32, I32, I32, I32, P),
    "mcn_scale_shift_act_bf16": (P, P, P, P, I64, I32, I32, I32, I32, I32,
                                 P),
    # int[4] out: bn_act.kernel_facts()
    "mcn_scale_shift_act_facts": (P,),
    # x, w1, s1, b1, w3, s3, b3, y, n, h, w, cin, cm, cout, TH, TW, CS (0,
    # 0, 0: the planner's), stream
    "mcn_conv_pair": (P, P, P, P, P, P, P, P,
                      I32, I32, I32, I32, I32, I32, I32, I32, I32, P),
    # n, h, w, cin, cm, cout, TH, TW, CS (as above), int[8] out: TH, TW,
    # CS, shared-memory bytes, ring stages, tiles of a phase-1 pass, tiles
    # of a phase-2 pass, clusters the card runs at once
    "mcn_conv_pair_plan": (I32, I32, I32, I32, I32, I32, I32, I32, I32, P),
    # x, w, scale, bias, y, n, h, w, c, cout, G, TH, TW, split, stream
    "mcn_conv3x3_bn_relu": (P, P, P, P, P, I32, I32, I32, I32, I32,
                            I32, I32, I32, I32, P),
    # int[7] out: shared-memory bytes a block, ring stages, blocks an SM
    # holds, SMs, clusters of 2, 4 and 8 the card holds at once
    "mcn_conv3x3_bn_relu_facts": (P,),
    # x, mean, std, y, total, c, path (0 an element a step, 1 16-byte
    # vectors), threads, blocks (normalize_u8.plan's), stream
    "mcn_normalize_u8_f32": (P, P, P, P, I64, I32, I32, I32, I32, P),
    "mcn_normalize_u8_bf16": (P, P, P, P, I64, I32, I32, I32, I32, P),
    # int[5] out: normalize_u8.kernel_facts()
    "mcn_normalize_u8_facts": (P,),
    # x, offsets [N, 2] int32, flip [N] bool, mean, std, y, n, h, w, c,
    # rows a band, direct (1: no staging), threads, blocks, shared-memory
    # bytes (pad_crop_u8.plan's), stream
    "mcn_pad_crop_u8_f32": (P, P, P, P, P, P, I32, I32, I32, I32, I32, I32,
                            I32, I32, I32, P),
    "mcn_pad_crop_u8_bf16": (P, P, P, P, P, P, I32, I32, I32, I32, I32, I32,
                             I32, I32, I32, P),
    # direct, threads, shared-memory bytes, int[4] out:
    # pad_crop_u8.kernel_facts(...)
    "mcn_pad_crop_u8_facts": (I32, I32, I32, P),
    # q, k, v, out, lse, strides [8 x 3], batch, heads, len, dim, scale,
    # stream
    "mcn_flash_fwd": (P, P, P, P, P, STRIDES, I32, I32, I32, I32, F32, P),
    # q, k, v, o, dO, lse, D (out), dq, strides, batch, heads, len, dim,
    # scale, stream
    "mcn_flash_bwd_dq": (P, P, P, P, P, P, P, P, STRIDES, I32, I32, I32,
                         I32, F32, P),
    # q, k, v, dO, lse, D, dk, dv, strides, batch, heads, len, dim, scale,
    # stream
    "mcn_flash_bwd_dkv": (P, P, P, P, P, P, P, P, STRIDES, I32, I32, I32,
                          I32, F32, P),
    # x, slope [N], offset [N], y, n, h, w, c, axis, fill, path, p0, p1
    # (affine.plan's), stream
    "mcn_shear_f32": (P, P, P, P, I32, I32, I32, I32, I32, F32, I32, I32,
                      I32, P),
    # int[5] out: affine.kernel_facts()
    "mcn_shear_facts": (P,),
    # x, op_idx [N] int64, signed_mag [N], y, n, H * W, c, path (0 one
    # pass, 1 two passes), p0, p1, scratch (randaugment_ew.plan's), stream
    "mcn_randaugment_ew_f32": (P, P, P, P, I32, I32, I32, I32, I64, I64, P,
                               P),
    # c, blocks a cluster, shared-memory bytes a block, int[7] out:
    # randaugment_ew.kernel_facts()
    "mcn_randaugment_ew_facts": (I32, I32, I32, P),
    # f1, f2, out, n, h, w, c, max displacement, stream
    "mcn_correlation_fwd_f32": (P, P, P, I32, I32, I32, I32, I32, P),
    "mcn_correlation_fwd_bf16": (P, P, P, I32, I32, I32, I32, I32, P),
    # g, the other feature map, its gradient (out), n, h, w, c, max
    # displacement, 0 for d_f1 (given f2) or 1 for d_f2 (given f1), stream
    "mcn_correlation_bwd_f32": (P, P, P, I32, I32, I32, I32, I32, I32, P),
    "mcn_correlation_bwd_bf16": (P, P, P, I32, I32, I32, I32, I32, I32, P),
    # mode (0 forward, 1 d_f1, 2 d_f2), f1 (forward), the segments' map,
    # g, out, n, h, w, c, max displacement, segment rows, panel channels,
    # ty, slots, aux slots, reuse, tma (the plan's), stream
    "mcn_correlation_tc": (I32, P, P, P, P, I32, I32, I32, I32, I32, I32,
                           I32, I32, I32, I32, I32, I32, P),
    # mode, c, max displacement, segment rows, panel channels, slots, aux
    # slots, int[6] out: correlation's kernel_facts()
    "mcn_correlation_tc_facts": (I32, I32, I32, I32, I32, I32, I32, P),
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


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def build_key(nvcc: str) -> str:
    h = hashlib.sha256()
    for f in sources() + headers():
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
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                    for src, obj in zip(sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        failed = []
        for cmd, proc in zip(compiles, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = [nvcc, "-shared", "-o", tmp_lib, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stderr}")
        os.replace(tmp_lib, lib)
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
