"""Build-on-demand ctypes loader of the host pack engine ``bfp_pack.cc``.

At first use the engine is compiled with ``g++`` into
``build/native/<hash of the source and flags>/libbfp_pack.so`` at the
repository root. The library is linked under a name that carries the
process id and renamed into place, and only the final path is loaded, so
processes that build at once (parallel test workers) never load a
half-written file. Without ``g++`` the engine is unavailable
(``native_available()`` is False, with a warning) and callers pack with the
torch packer on the CPU, which gives the same bits; a failed compile or
load with ``g++`` present raises.

``native_pack_int8`` and ``native_pack_subbyte`` take and return numpy
arrays in the layouts of ``kernels/packing.py``; each call adds one to its
``calls`` attribute.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "bfp_pack.cc"
BUILD_ROOT = _SRC.parent.parent.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_state = {}  # "lib": the loaded library, or None when there is no g++


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libbfp_pack.so"


def build(cxx: str) -> Path:
    """Compile the engine (once for a given source and flags); -> its path.
    Raises with the compiler's output on failure."""
    lib_path = _lib_path()
    if lib_path.exists():
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"libbfp_pack.{os.getpid()}.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"native bfp_pack build failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        cxx = shutil.which("g++")
        if cxx is None:
            logger.warning("no g++ for the native bfp_pack engine; packing on the host "
                           "with the torch packer")
            _state["lib"] = None
            return None
        lib = ctypes.CDLL(str(build(cxx)))
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.bfp_pack_int8.argtypes = [f32p, i64, i64, i32, i32, i32, i32, i8p, f32p, i32]
        lib.bfp_pack_int8.restype = None
        lib.bfp_pack_subbyte.argtypes = [f32p, i64, i64, i32, i32, i32, i32, u32p, f32p, i32]
        lib.bfp_pack_subbyte.restype = None
        _state["lib"] = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def _n_threads() -> int:
    return min(os.cpu_count() or 1, 16)


def _prep(w, multiple: int):
    w = np.ascontiguousarray(w, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(f"expected a 2-D weight, got shape {w.shape}")
    pad = (-w.shape[1]) % multiple
    if pad:
        w = np.pad(w, ((0, 0), (0, pad)))
    return w


def _bias(exponent_bias) -> int:
    return -1 if exponent_bias in (None, "none", "None") else int(exponent_bias)


def native_pack_int8(w, width, exponent_width=8, exponent_bias=None, block=16,
                     k_stride=None):
    """numpy [out, in] -> (codes int8 [out, in_pad], scales float32
    [out, in_pad / block]), K padded to ``k_stride`` (a multiple of
    ``block``) or to the block; None when the engine is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if not 2 <= width <= 8:
        raise ValueError(f"int8 code storage needs width in [2, 8], got {width}")
    if k_stride and k_stride % block:
        raise ValueError(f"k_stride {k_stride} is not a multiple of the block {block}")
    w = _prep(w, k_stride or block)
    out, in_padded = w.shape
    codes = np.empty((out, in_padded), dtype=np.int8)
    scales = np.empty((out, in_padded // block), dtype=np.float32)
    lib.bfp_pack_int8(w, out, in_padded, width, exponent_width, _bias(exponent_bias), block,
                      codes, scales, _n_threads())
    native_pack_int8.calls += 1
    return codes, scales


def native_pack_subbyte(w, width, exponent_width=8, exponent_bias=None, block=16):
    """numpy [out, in] -> (words uint32 [out, in_pad / per_word], scales
    uint8 [n_tiles, out, tile / block], the biased exponents 2^(u8 - 128)),
    K padded to the tile (32 // width) * 128; None when the engine is
    unavailable. The engine emits float32 powers of two; their exponent
    bytes are read here with frexp (exact), and a scale flushed to 0 maps
    to byte 0."""
    lib = _load()
    if lib is None:
        return None
    if not 2 <= width <= 8:
        raise ValueError(f"sub-byte packing needs width in [2, 8], got {width}")
    if 128 % block:
        raise ValueError(f"sub-byte packing needs a block dividing 128, got {block}")
    per_word = 32 // width
    tile = per_word * 128
    w = _prep(w, tile)
    out, in_padded = w.shape
    words = np.empty((out, in_padded // per_word), dtype=np.uint32)
    scales = np.empty((in_padded // tile, out, tile // block), dtype=np.float32)
    lib.bfp_pack_subbyte(w, out, in_padded, width, exponent_width, _bias(exponent_bias),
                         block, words, scales, _n_threads())
    native_pack_subbyte.calls += 1
    _, ex = np.frexp(scales)
    e = np.where(scales > 0, ex - 1, -1 << 20)
    return words, np.clip(e + 128, 0, 255).astype(np.uint8)


native_pack_int8.calls = 0
native_pack_subbyte.calls = 0


def native_calls() -> int:
    """Calls of the engine since the last ``reset_native_calls``."""
    return native_pack_int8.calls + native_pack_subbyte.calls


def reset_native_calls():
    native_pack_int8.calls = native_pack_subbyte.calls = 0
