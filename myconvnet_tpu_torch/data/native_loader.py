"""ctypes binding of the port's host data library (csrc/host/dataloader.cc).

Port of ``myconvnet_tpu/data/native_loader.py``.  At first use (never at
import) g++ builds the library into ``build/host/<hash>/libmcn_data.so``
at the root of the checkout; ``<hash>`` covers the source, the flags and
the compiler, so an edit rebuilds and an unchanged tree reuses it.  The
compiler writes a temporary file beside it that ``os.replace`` moves into
place, so processes that build at once never load half a file.  JPEG and
PNG decoding are compiled in (``-DMCN_WITH_JPEG -ljpeg``,
``-DMCN_WITH_PNG -lpng``) where the compiler finds ``jpeglib.h`` and
``png.h``.

Every entry point has the JAX package's numpy or Pillow fallback, so the
port runs without a toolchain; :func:`backend` says which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "host" / "dataloader.cc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "host"
LIB_NAME = "libmcn_data.so"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
# (define, header, library) of each optional codec
CODECS = (("MCN_WITH_JPEG", "jpeglib.h", "jpeg"),
          ("MCN_WITH_PNG", "png.h", "png"))

_lock = threading.Lock()
_lib = None
_lib_tried = False
_lib_path = None

U8P = ctypes.POINTER(ctypes.c_uint8)
I64P = ctypes.POINTER(ctypes.c_int64)
F32P = ctypes.POINTER(ctypes.c_float)
IP = ctypes.POINTER(ctypes.c_int)


def has_header(name: str) -> bool:
    """Whether the C++ compiler finds ``#include <name>``."""
    try:
        proc = subprocess.run([CXX, "-E", "-x", "c++", "-o", os.devnull, "-"],
                              input=f"#include <{name}>\n", text=True,
                              capture_output=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


def build_command(out: str, codecs=None) -> list[str]:
    """The g++ command that builds the library into ``out``, with each
    codec of ``codecs`` (default: those whose header the compiler
    finds)."""
    if codecs is None:
        codecs = [c for c in CODECS if has_header(c[1])]
    return [CXX, *CXX_FLAGS, *[f"-D{d}" for d, _, _ in codecs], "-o", out,
            str(SOURCE), *[f"-l{lib}" for _, _, lib in codecs]]


def build() -> Path:
    """Compile the library unless this source, these flags and this
    compiler built it already; returns its path.  Raises when g++ fails."""
    version = subprocess.run([CXX, "--version"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    codecs = [c for c in CODECS if has_header(c[1])]
    key = hashlib.sha256()
    for part in (SOURCE.read_bytes(),
                 " ".join(build_command(LIB_NAME, codecs)).encode(),
                 version.encode()):
        key.update(part)
    out_dir = BUILD_DIR / key.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.{threading.get_ident()}"
    try:
        subprocess.run(build_command(str(tmp), codecs), check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, lib)
    finally:
        if tmp.exists():
            tmp.unlink()
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.mcn_shuffle_indices.argtypes = [ctypes.c_uint64, ctypes.c_int64,
                                        I64P]
    lib.mcn_shuffle_indices.restype = None
    lib.mcn_gather_batch.argtypes = [U8P, I64P, ctypes.c_int64,
                                     ctypes.c_int64, U8P, ctypes.c_int]
    lib.mcn_gather_batch.restype = None
    lib.mcn_u8_to_f32_normalize.argtypes = [U8P, F32P, F32P, F32P,
                                            ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_int]
    lib.mcn_u8_to_f32_normalize.restype = None
    lib.mcn_has_jpeg.argtypes = []
    lib.mcn_has_jpeg.restype = ctypes.c_int
    lib.mcn_has_png.argtypes = []
    lib.mcn_has_png.restype = ctypes.c_int
    if lib.mcn_has_jpeg():
        lib.mcn_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), I64P, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, U8P, IP, ctypes.c_int]
        lib.mcn_decode_jpeg_batch.restype = None
    if lib.mcn_has_png():
        lib.mcn_png_info.argtypes = [U8P, ctypes.c_int64, IP, IP]
        lib.mcn_png_info.restype = ctypes.c_int
        lib.mcn_decode_png.argtypes = [U8P, ctypes.c_int64, ctypes.c_int,
                                       U8P, ctypes.c_int64]
        lib.mcn_decode_png.restype = ctypes.c_int


def _load() -> ctypes.CDLL | None:
    """The library, built and loaded on the first call of the process;
    None when g++ or the load fails (every caller has a fallback)."""
    global _lib, _lib_tried, _lib_path
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        try:
            path = build()
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError):
            return None
        _bind(lib)
        _lib, _lib_path = lib, path
        return _lib


def _threads(n_threads: int | None) -> int:
    return n_threads or min(8, os.cpu_count() or 1)


def backend() -> dict:
    """Which host path runs: ``{"jpeg": native JPEG decode, "png": native
    PNG decode, "built": the library's path (None: numpy/Pillow only)}``."""
    lib = _load()
    return {"jpeg": bool(lib is not None and lib.mcn_has_jpeg()),
            "png": bool(lib is not None and lib.mcn_has_png()),
            "built": str(_lib_path) if lib is not None else None}


def native_available() -> bool:
    return _load() is not None


def shuffle_indices(seed: int, n: int) -> np.ndarray:
    """Deterministic permutation of [0, n) (native Fisher-Yates, numpy
    fallback)."""
    lib = _load()
    if lib is None:
        return np.random.RandomState(seed & 0xFFFFFFFF).permutation(n)
    out = np.empty(n, np.int64)
    lib.mcn_shuffle_indices(ctypes.c_uint64(seed), ctypes.c_int64(n),
                            out.ctypes.data_as(I64P))
    return out


def gather_batch(pool: np.ndarray, idx: np.ndarray,
                 n_threads: int | None = None) -> np.ndarray:
    """pool[idx] as one contiguous batch by a threaded memcpy.

    pool: [N, ...] uint8 C-contiguous (other pools take numpy's fancy
    indexing); idx: integer [B], each in [0, N).
    """
    idx = np.ascontiguousarray(idx, np.int64)
    if pool.dtype != np.uint8 or not pool.flags.c_contiguous:
        return np.ascontiguousarray(pool[idx])
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(pool[idx])
    if len(idx) and (idx.min() < 0 or idx.max() >= len(pool)):
        raise IndexError(f"gather_batch: indices outside [0, {len(pool)})")
    item_bytes = int(np.prod(pool.shape[1:]))
    out = np.empty((len(idx), *pool.shape[1:]), np.uint8)
    lib.mcn_gather_batch(pool.ctypes.data_as(U8P), idx.ctypes.data_as(I64P),
                         ctypes.c_int64(len(idx)), ctypes.c_int64(item_bytes),
                         out.ctypes.data_as(U8P),
                         ctypes.c_int(_threads(n_threads)))
    return out


def native_jpeg_available() -> bool:
    lib = _load()
    return bool(lib is not None and lib.mcn_has_jpeg())


def decode_jpeg_batch(blobs: list[bytes], raw_hw: tuple[int, int],
                      n_threads: int | None = None) -> np.ndarray:
    """JPEG byte strings -> [N, th, tw, 3] uint8 with the pipeline's
    cover-resize + center-crop geometry: threaded native libjpeg
    (DCT-prescaled); an image the library cannot decode (another
    container, a corrupt file) goes through Pillow."""
    th, tw = raw_hw
    n = len(blobs)
    out = np.empty((n, th, tw, 3), np.uint8)
    lib = _load()
    if lib is not None and lib.mcn_has_jpeg() and n:
        bufs = [np.frombuffer(b, np.uint8) for b in blobs]
        ptrs = (ctypes.c_void_p * n)(*[b.ctypes.data for b in bufs])
        lens = np.asarray([len(b) for b in blobs], np.int64)
        status = np.zeros(n, np.intc)
        lib.mcn_decode_jpeg_batch(
            ptrs, lens.ctypes.data_as(I64P), ctypes.c_int64(n),
            ctypes.c_int(th), ctypes.c_int(tw), out.ctypes.data_as(U8P),
            status.ctypes.data_as(IP), ctypes.c_int(_threads(n_threads)))
        failed = np.nonzero(status)[0]
    else:
        failed = np.arange(n)
    for i in failed:
        out[i] = _decode_pil(blobs[i], raw_hw)
    return out


def _decode_pil(blob: bytes, raw_hw: tuple[int, int]) -> np.ndarray:
    import io

    from myconvnet_tpu_torch.data.pipeline import (cover_resize_center_crop,
                                                   pil_image)
    image = pil_image("native_loader.decode_jpeg_batch's fallback",
                      "an image libjpeg could not decode")
    return cover_resize_center_crop(
        image.open(io.BytesIO(blob)).convert("RGB"), raw_hw)


def normalize_u8_host(images: np.ndarray, mean, std,
                      n_threads: int | None = None) -> np.ndarray:
    """(x / 255 - mean) / std on the host, as x * (1 / (255 std)) - mean /
    std in float32 (the CPU path; the card normalizes on the device)."""
    c = images.shape[-1]
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    scale = (1.0 / (255.0 * std)).astype(np.float32)
    shift = (-mean / std).astype(np.float32)
    lib = _load()
    if lib is None or images.dtype != np.uint8 or \
            not images.flags.c_contiguous:
        return images.astype(np.float32) * scale + shift
    if len(scale) != c or len(shift) != c:
        raise ValueError(f"mean/std have {len(mean)}/{len(std)} entries "
                         f"for {c} channels")
    out = np.empty(images.shape, np.float32)
    lib.mcn_u8_to_f32_normalize(
        images.ctypes.data_as(U8P), out.ctypes.data_as(F32P),
        scale.ctypes.data_as(F32P), shift.ctypes.data_as(F32P),
        ctypes.c_int64(images.size // c), ctypes.c_int64(c),
        ctypes.c_int(_threads(n_threads)))
    return out


def native_png_available() -> bool:
    lib = _load()
    return bool(lib is not None and lib.mcn_has_png())


def decode_png(blob: bytes, mode: str = "rgb") -> np.ndarray | None:
    """Decode one PNG natively: mode "rgb" -> [H, W, 3] uint8 (palette and
    gray expanded); "raw" -> [H, W] uint8 of palette INDICES or gray
    values (a VOC mask's class id is its palette index).  None where the
    native path is missing or declines (junk, raw mode on a truecolor or
    16-bit image): callers fall back to Pillow."""
    if mode not in ("rgb", "raw"):
        raise ValueError(f"decode_png mode {mode!r}; valid: ['rgb', 'raw']")
    lib = _load()
    if lib is None or not lib.mcn_has_png():
        return None
    buf = np.frombuffer(blob, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.mcn_png_info(buf.ctypes.data_as(U8P), ctypes.c_int64(len(blob)),
                        ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    raw = mode == "raw"
    out = np.empty((h.value, w.value) if raw else (h.value, w.value, 3),
                   np.uint8)
    rc = lib.mcn_decode_png(buf.ctypes.data_as(U8P),
                            ctypes.c_int64(len(blob)),
                            ctypes.c_int(1 if raw else 0),
                            out.ctypes.data_as(U8P),
                            ctypes.c_int64(out.nbytes))
    return out if rc == 0 else None
