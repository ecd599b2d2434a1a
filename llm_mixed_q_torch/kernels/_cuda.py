"""Build and load the Hopper kernels.

The CUDA C++ sources under ``llm_mixed_q_torch/csrc/`` have a plain C
interface. They form two source sets, each linked into a shared library of
its own: ``kernels`` (``csrc/*.cu``, the serving kernels) and ``probes``
(``csrc/probes/*.cu``, the probe kernels of ``llm_mixed_q_torch.tools``),
so the probes add nothing to the serving library's build time. At first
use a set is compiled for ``sm_90a`` with ``nvcc`` (one process per
source, all started together), linked and loaded with ``ctypes``. The
library lands in ``build/kernels/<hash of sources and flags>/`` at the
repository root, so an edited source is rebuilt and an unchanged one is
not; ``build_all`` builds several sets at once. The kernels are
built from a checkout of the repository: an installed copy of the package
carries no sources and raises when a kernel is first asked for.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types (pointers and the stream are
# c_void_p, so ctypes never cuts a 64-bit address), by source set
_SIGNATURES = {
    "kernels": {
        # x, words, scales, y, M, N, K, k_pad, width, bs, aq_on, aq_bs,
        # aq_width, aq_emin, aq_emax, stream
        "lmq_bfp_matmul_subbyte_t": [_P, _P, _P, _P] + [_I] * 11 + [_P],
        "lmq_bfp_matmul_subbyte": [_P, _P, _P, _P] + [_I] * 11 + [_P],
        # x, codes, scales, y, M, N, K, k_pad, bs, aq_on, aq_bs, aq_width,
        # aq_emin, aq_emax, stream
        "lmq_bfp_matmul_int8": [_P, _P, _P, _P] + [_I] * 10 + [_P],
        # q, kc, ks, vc, vs, positions, out, b, nkv, rep, hd, S, bs_k, bs_v,
        # sqrt_hd, pq_on, pq_bs, pq_width, pq_emin, pq_emax, stream
        "lmq_attn_decode_pos_major": [_P] * 7 + [_I] * 7 + [_F] + [_I] * 5 + [_P],
        "lmq_attn_decode_head_major": [_P] * 7 + [_I] * 7 + [_F] + [_I] * 5 + [_P],
    },
    "probes": {
        # x, words, scales, y, M, N, Kx, k_pad, width, bs, layout, variant,
        # stream
        "lmq_probe_subbyte": [_P, _P, _P, _P] + [_I] * 8 + [_P],
        # the same arguments; variant: 0 v2, 1 v3, 2 v4_f32s, 3 v4_bf16s
        "lmq_probe_variant": [_P, _P, _P, _P] + [_I] * 8 + [_P],
        # x, codes, scales, y, M, N, Kx, k_pad, bs, bf16 (scale type), stream
        "lmq_probe_int8": [_P, _P, _P, _P] + [_I] * 6 + [_P],
        # q, kc, ks, vc, vs, positions, out, b, nkv, rep, hd, S, bs_k, bs_v,
        # sqrt_hd, pq_on, pq_bs, pq_width, pq_emin, pq_emax, stage, bf16,
        # stream
        "lmq_probe_attention": [_P] * 7 + [_I] * 7 + [_F] + [_I] * 7 + [_P],
        # x, words, scales, y, M, N, Kx, k_pad, width, bs, cols, tps, stream
        "lmq_probe_subbyte_tile": [_P, _P, _P, _P] + [_I] * 8 + [_P],
        # width, bs, cols, tps, &blocks
        "lmq_probe_subbyte_tile_occupancy": [_I] * 4 + [_P],
        # x, codes, scales, out, M, N, Kx, k_pad, bs, cols, kstep, band, stream
        "lmq_probe_int8_tile": [_P, _P, _P, _P] + [_I] * 8 + [_P],
        # ws, y, bands, n, stream
        "lmq_probe_band_sum": [_P, _P, _I, ctypes.c_int64, _P],
        # cols, kstep, &blocks
        "lmq_probe_int8_tile_occupancy": [_I, _I, _P],
    },
}
_SOURCE_DIRS = {"kernels": CSRC, "probes": CSRC / "probes"}

_LIBS = {}
BUILD_SECONDS = {}  # source set -> wall time of its build, when this process built it


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _build_dir(name: str) -> Path:
    src_dir = _SOURCE_DIRS[name]
    # a set's own sources and the shared headers of csrc/
    sources = sorted(src_dir.glob("*.cu")) + sorted(src_dir.glob("*.cuh"))
    if src_dir != CSRC:
        sources += sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(name: str = "kernels") -> Path:
    """Compile every source of set ``name`` in parallel and link them into
    one library; returns its path. Raises with nvcc's output on failure.
    Objects carry the process id and the library is renamed into place, so
    processes that build at once do not clobber each other."""
    src_dir = _SOURCE_DIRS[name]
    if not any(src_dir.glob("*.cu")):
        raise RuntimeError(
            f"no CUDA sources in {src_dir}: the kernels build from a checkout of "
            "the repository (run from its root)")
    out_dir = _build_dir(name)
    lib_path = out_dir / f"liblmq_{name}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    pid = os.getpid()
    t0 = time.perf_counter()
    procs = []
    for src in sorted(src_dir.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs = [], []
    for cmd, obj, p in procs:
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
        objs.append(str(obj))
    tmp = out_dir / f"liblmq_{name}.{pid}.so"
    cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
           "-o", str(tmp), *objs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"link failed ({' '.join(cmd)}):\n{res.stdout}{res.stderr}")
    (out_dir / "nvcc.log").write_text("".join(logs))
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return lib_path


def build_all(names=tuple(_SOURCE_DIRS)) -> list[Path]:
    """Build several source sets at once (every nvcc of every set starts
    together); returns their library paths."""
    with ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


def build_log(name: str = "kernels") -> str:
    """nvcc's output of the build in use (ptxas registers, shared memory,
    spills of every kernel)."""
    log = _build_dir(name) / "nvcc.log"
    return log.read_text() if log.exists() else ""


def lib(name: str = "kernels"):
    """The loaded library of source set ``name`` (built at first use)."""
    if name not in _LIBS:
        handle = ctypes.CDLL(str(build(name)))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(handle, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.lmq_error_string.argtypes = [ctypes.c_int]
        handle.lmq_error_string.restype = ctypes.c_char_p
        _LIBS[name] = handle
    return _LIBS[name]


def check(rc: int, name: str):
    if rc != 0:
        any_lib = next(iter(_LIBS.values()), None)
        msg = any_lib.lmq_error_string(rc).decode() if any_lib is not None else ""
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
