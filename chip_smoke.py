"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole run
    python3 chip_smoke.py --k1-only       # build, then K1's checks and times only
    python3 chip_smoke.py --probes-only   # build, then the probe phase (7) only

1. builds the Hopper kernels from ``llm_mixed_q_torch/csrc`` and the probe
   kernels from ``llm_mixed_q_torch/csrc/probes`` (two libraries, every
   nvcc started at once, sm_90a) and counts the HMMA (tensor-core)
   instructions of K1's and P8's SASS (``cuobjdump -sass``; the whole run
   fails if there are none);
2. holds each kernel against its plain PyTorch version on the card at the
   Llama-2-7B decode shapes (batch 8; the matmuls also at the 256 rows of a
   prefill; the sub-byte matmuls K1 and K3 also at the OPT-6.7B fc1/fc2
   shapes) and times kernel, plain version, library yardstick and the
   memory/compute bound (K1 also at 256 rows, ``prefill_*``; its operations
   bound at the bf16 tensor-core peak, the others' at the float32 one);
3. builds Llama-2-7B widths with random weights (seed 0), W6A6 block_fp
   (configs/quantization/bfp_6bit.toml), bf16 embedding / lm_head;
4. runs ``generate`` on sub-byte weights (pos-major cache: K1 + K4) and
   ``ContinuousBatcher`` on int8 weights (head-major cache: K2 + K5), each
   with every launch counter set to 0 just before it and read just after
   it (each run must launch its two kernels and no other); then the
   batcher's tokens must equal reference ``generate`` rows for the same
   prompts;
5. holds one decode step's logits, kernel path against plain path (the
   plain path patches the wrappers here, in this script), and counts the
   launches of that step;
6. frees the Llama trees and builds OPT-6.7B widths (32 layers, random
   weights seed 0, W6A6 block_fp) twice: packed by ``init_opt_params``
   (transposed sub-byte words: K1) and with ``pack_common._to_t`` patched
   to the identity here (lane-major ``PackedBFPSub`` words: K3); runs OPT
   ``generate`` on each tree with the launch counters reset and read around
   it (K1 only, then K3 only; OPT decodes on a float32 cache, so no
   attention kernel), and holds a decode step of each tree against the
   plain path;
7. the probes (``llm_mixed_q_torch.tools``): holds every probe kernel
   (P8 and P9, the sub-byte matmul's knock-outs in K1's and K3's layouts,
   P1 and P3, its dequant-arithmetic and scale-storage variants in both
   layouts, P2, bf16 and float32 scales for the int8 matmul, and the
   tiling sweeps P4/P7 (``subbyte_tile``: K3's column tile and tiles a
   step) and P6/P5 (``int8_tile``: K2's column tile, K a step and K bands,
   with ``band_sum``), at the four Llama-2-7B projection shapes; P11,
   decode attention's knock-outs, at the probe's b = 32, S = 256) against
   its plain version, and each probe's copy of its production kernel
   against that kernel on bf16 x with no activation quantizer (transposed
   ship, v2 and v4 == K1; lane-major ship, v2, v4 and every
   ``subbyte_tile`` instance == K3; P2 with either scale type and every
   ``int8_tile`` instance without bands == K2; v3 and the band instance
   within 1e-5 of max|y|; the quant stage with float32 dots == K4), then
   drives the six probe entry points (``ksub.run``, ``kvariants.run``,
   ``kvariants2.run``, ``aprobe.run``, ``kprobe.run``, ``ktune7b.run``)
   with the launch counters set to 0 before each and read after it. The
   probe rows' ``ms`` come from those runs (``band_sum``'s from a call of
   its own); every serving path above launches no probe.

Any failed check raises (non-zero exit). The last line of stdout is the
device JSON; the kernel table is the JSON line before the ``nvidia-smi``
line. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 8
ACTQ = (16, 6, 8, 127)  # data_in block_fp of bfp_6bit.toml: [1, 16], W6, e8
PROB_Q = (16, 6, 8, 127)
# Llama-2-7B widths
HIDDEN, INTER, LAYERS, HEADS, VOCAB = 4096, 11008, 32, 32, 32000
MATMUL_SHAPES = {  # name: (N, K) of one decoder layer's projections
    "qkv_proj": (3 * HIDDEN, HIDDEN),
    "o_proj": (HIDDEN, HIDDEN),
    "gate_up_proj": (2 * INTER, HIDDEN),
    "down_proj": (HIDDEN, INTER),
}
# OPT-6.7B widths (config.json of facebook/opt-6.7b)
OPT_HIDDEN, OPT_FFN, OPT_LAYERS, OPT_HEADS, OPT_VOCAB = 4096, 16384, 32, 32, 50272
# the OPT shapes K1/K3 meet that no Llama shape above covers (q/k/v/out_proj
# are o_proj's 4096 x 4096)
OPT_MLP_SHAPES = {"fc1": (OPT_FFN, OPT_HIDDEN), "fc2": (OPT_HIDDEN, OPT_FFN)}
PREFILL_M = 256  # rows of a batch of 8 prompts of 32 tokens: the largest M bfp_matmul
# sends to the kernels


def log(*a):
    print(*a, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def all_launch_counts() -> dict[str, int]:
    """Launch counts of the serving kernels and of the probes."""
    from llm_mixed_q_torch import kernels, tools

    return {**kernels.launch_counts(), **tools.launch_counts()}


def reset_all_launch_counts():
    from llm_mixed_q_torch import kernels, tools

    kernels.reset_launch_counts()
    tools.reset_launch_counts()


@contextlib.contextmanager
def plain_path():
    """Route the serving path's kernel wrappers to their plain versions, to
    compare a decode step of the kernel path with the plain path on the card
    (the package has no switch for this: a wrapper given CUDA tensors always
    launches its kernel)."""
    from llm_mixed_q_torch.kernels import attention_decode as ad
    from llm_mixed_q_torch.kernels import dequant_matmul as dm
    from llm_mixed_q_torch.models.llama import serving

    with mock.patch.object(dm, "bfp_matmul_subbyte_t_cuda", dm.bfp_matmul_plain), \
            mock.patch.object(dm, "bfp_matmul_subbyte_cuda", dm.bfp_matmul_plain), \
            mock.patch.object(dm, "bfp_matmul_cuda", dm.bfp_matmul_plain), \
            mock.patch.object(serving, "packed_attention_decode_batch_cuda",
                              ad.packed_attention_decode_batch_plain), \
            mock.patch.object(serving, "packed_attention_decode_cuda",
                              ad.packed_attention_decode_plain):
        yield


def bound(nbytes, flops, peaks):
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _measure_matmul(kname, wrapper, packed, n, k, gen, peaks, flush, tensor_cores=False):
    """Hold one kernel against its plain version at decode rows (batch 8)
    and at the PREFILL_M rows of a prefill; time it at batch 8, and a
    tensor-core kernel (K1) also at PREFILL_M rows (``prefill_*``). The
    operations bound is taken at the peak of the units the kernel runs on:
    bf16 tensor cores for K1, float32 CUDA cores for the others."""
    from llm_mixed_q_torch.kernels.dequant_matmul import bfp_matmul_plain
    from llm_mixed_q_torch.kernels.packing import packed_nbytes, unpack
    from llm_mixed_q_torch.tools.timing import cuda_ms

    xs = {m: torch.randn((m, k), generator=gen, device="cuda") for m in (BATCH, PREFILL_M)}
    errs = {}
    for m, xm in xs.items():
        y = wrapper(xm, packed, ACTQ)
        ref = bfp_matmul_plain(xm, packed, ACTQ)
        torch.cuda.synchronize()
        e = (y - ref).abs().max().item()
        rel = e / ref.abs().max().item()
        # tolerance of the JAX package's own kernel test: 1e-4 of max|y|
        # (float32 sums in another order)
        check(rel <= 1e-4, f"{kname} N={n} K={k} M={m}: rel err {rel}")
        errs[m] = (e, rel)
    w_bf16 = unpack(packed, torch.bfloat16)
    op_peak = peaks[2] if tensor_cores else peaks[1]
    out = {}
    for m in (BATCH, PREFILL_M) if tensor_cores else (BATCH,):
        x, x_bf16 = xs[m], xs[m].to(torch.bfloat16)
        pre = "" if m == BATCH else "prefill_"
        out[pre + "ms"] = cuda_ms(lambda: wrapper(x, packed, ACTQ), flush=flush)
        out[pre + "library_ms"] = cuda_ms(lambda: torch.matmul(x_bf16, w_bf16.t()), flush=flush)
        nbytes = packed_nbytes(packed) + 4 * m * (k + n)
        out[pre + "bound_bytes_ms"] = nbytes / peaks[0] * 1e3
        out[pre + "bound_ops_ms"] = 2 * m * n * k / op_peak * 1e3
    out["plain_ms"] = cuda_ms(lambda: bfp_matmul_plain(xs[BATCH], packed, ACTQ), reps=5,
                              flush=flush)
    del w_bf16
    for m in (BATCH, PREFILL_M) if tensor_cores else (BATCH,):
        pre = "" if m == BATCH else "prefill_"
        log(f"  {kname} N={n} K={k} M={m}: max_abs_err={errs[m][0]:.3e} "
            f"(rel {errs[m][1]:.2e}) kernel_ms={out[pre + 'ms']:.4f} "
            f"bound_ms={max(out[pre + 'bound_bytes_ms'], out[pre + 'bound_ops_ms']):.4f} "
            f"library_ms(bf16 matmul on the pre-dequantized weight)="
            f"{out[pre + 'library_ms']:.4f}")
    log(f"  {kname} N={n} K={k} M={BATCH}: plain_ms={out['plain_ms']:.4f}")
    out["max_abs_err"] = max(e for e, _ in errs.values())
    return out


def check_matmul_kernels(peaks, flush, only=None):
    """Rows: sums over one Llama-2-7B layer's four projections at batch 8
    (K1 also at PREFILL_M rows); K1 and K3 also report the OPT-6.7B MLP
    shapes, on lines of their own (``opt_mlp_ms``, K1 also
    ``opt_mlp_prefill_ms``). ``only``: the one kernel to measure."""
    from llm_mixed_q_torch.kernels.dequant_matmul import (
        bfp_matmul_cuda, bfp_matmul_subbyte_cuda, bfp_matmul_subbyte_t_cuda)
    from llm_mixed_q_torch.kernels.packing import (
        pack_block_fp, pack_block_fp_subbyte, pack_block_fp_subbyte_t)
    from llm_mixed_q_torch.models.pack_common import _k_stride

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = {
        "bfp_matmul_subbyte_t": (bfp_matmul_subbyte_t_cuda, pack_block_fp_subbyte_t),
        "bfp_matmul_int8": (bfp_matmul_cuda, lambda w, *a: pack_block_fp(
            w, *a, k_stride=_k_stride(16, w.shape[1]))),
        "bfp_matmul_subbyte": (bfp_matmul_subbyte_cuda, pack_block_fp_subbyte),
    }
    rows = {}
    for kname, (wrapper, packer) in kernels.items():
        if only is not None and kname != only:
            continue
        tensor_cores = kname == "bfp_matmul_subbyte_t"
        tot = {"max_abs_err": 0.0}
        shapes = dict(MATMUL_SHAPES)
        if kname != "bfp_matmul_int8":
            shapes.update(OPT_MLP_SHAPES)
            tot["opt_mlp_ms"] = {}
            if tensor_cores:
                tot["opt_mlp_prefill_ms"] = {}
        for sname, (n, k) in shapes.items():
            w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
            packed = packer(w, 6, 8, 127, [1, 16])
            del w
            r = _measure_matmul(f"{kname} {sname}", wrapper, packed, n, k, gen, peaks, flush,
                                tensor_cores)
            tot["max_abs_err"] = max(tot["max_abs_err"], r.pop("max_abs_err"))
            if sname in OPT_MLP_SHAPES:
                tot["opt_mlp_ms"][sname] = r["ms"]
                if tensor_cores:
                    tot["opt_mlp_prefill_ms"][sname] = r["prefill_ms"]
                continue
            for key, v in r.items():
                tot[key] = tot.get(key, 0.0) + v
        rows[kname] = tot
    return rows


def _cache_inputs(gen, s_len, nkv, hd, pos_major):
    """A filled packed cache of random K/V, as serving lays it out."""
    from llm_mixed_q_torch.kernels.packing import bfp_encode_lastdim

    k = torch.randn((BATCH, nkv, s_len, hd), generator=gen, device="cuda")
    v = torch.randn((BATCH, nkv, s_len, hd), generator=gen, device="cuda")
    kc, ks = bfp_encode_lastdim(k, 6, 8, 127, 16)
    vc, vs = bfp_encode_lastdim(v, 6, 8, 127, 16)
    if pos_major:
        flat = lambda t: t.permute(0, 3, 2, 1).reshape(BATCH, t.shape[3], s_len * nkv).contiguous()
        return flat(kc), flat(ks), flat(vc), flat(vs)
    return (kc.transpose(2, 3).contiguous(), ks.transpose(2, 3).contiguous(),
            vc.contiguous(), vs.contiguous())


def check_attention_kernels(peaks, flush):
    from llm_mixed_q_torch.kernels.attention_decode import (
        packed_attention_decode_batch_cuda, packed_attention_decode_batch_plain,
        packed_attention_decode_cuda, packed_attention_decode_plain)
    from llm_mixed_q_torch.ops.quantizers import _block_fp_qdq
    from llm_mixed_q_torch.tools.timing import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    nkv, hd = HEADS, HIDDEN // HEADS
    rows = {}
    for kname, s_len, pos_major in (("attn_decode_pos_major", 256, True),
                                    ("attn_decode_head_major", 512, False)):
        positions = torch.tensor([s_len - 1 - 9 * i for i in range(BATCH)],
                                 dtype=torch.int32, device="cuda")
        cache = _cache_inputs(gen, s_len, nkv, hd, pos_major)
        q = _block_fp_qdq(torch.randn((BATCH * nkv, hd), generator=gen, device="cuda"),
                          6, 8, 127, [1, 16], True)
        if pos_major:
            q = q.reshape(BATCH, nkv, hd)
            run = lambda: packed_attention_decode_batch_cuda(
                q, *cache, positions, 16, 16, nkv=nkv, rep=1, prob_q=PROB_Q)
            plain = lambda: packed_attention_decode_batch_plain(
                q, *cache, positions, 16, 16, nkv=nkv, rep=1, prob_q=PROB_Q)
        else:
            q = q.reshape(BATCH, nkv, 1, hd)
            run = lambda: packed_attention_decode_cuda(
                q, *cache, positions, 16, 16, prob_q=PROB_Q)
            plain = lambda: packed_attention_decode_plain(
                q, *cache, positions, 16, 16, prob_q=PROB_Q)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # tolerance of the JAX package's kernel test (rtol 2e-4 / atol 2e-5)
        check(torch.allclose(out, ref, rtol=2e-4, atol=2e-5), f"{kname}: max err {err}")
        ms = cuda_ms(run, flush=flush)
        plain_ms = cuda_ms(plain, reps=5, flush=flush)
        # yardstick: SDPA on the dequantized float32 cache, masked to the
        # filled positions (no prob quantization)
        kd = (torch.randn((BATCH, nkv, s_len, hd), generator=gen, device="cuda"))
        vd = torch.randn_like(kd)
        mask = (torch.arange(s_len, device="cuda")[None, None, None, :]
                <= positions.long()[:, None, None, None])
        qd = q.reshape(BATCH, nkv, 1, hd)
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask), flush=flush)
        filled = int((positions.long() + 1).sum().item())  # positions read
        per_pos = nkv * (2 * hd + 2 * (hd // 16) * 4)  # K+V codes and scales
        nbytes = filled * per_pos + 4 * q.numel() * 2 + 4 * BATCH
        flops = filled * nkv * 4 * hd
        b_ms, b_by = bound(nbytes, flops, peaks)
        log(f"  {kname} max_len={s_len}: max_abs_err={err:.3e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"library_ms(SDPA on a dequantized f32 cache)={library_ms:.4f}")
        rows[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=library_ms, max_abs_err=err)
    return rows


def count_sass(lib_path, function, opcode):
    """How many ``opcode`` instructions the SASS of the kernels whose name
    holds ``function`` has in the built library (cuobjdump -sass)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = name if function in name else None
            if current is not None:
                counts.setdefault(current, 0)
        elif current is not None and f" {opcode}" in line:
            counts[current] = counts.get(current, 0) + 1
    check(counts, f"no SASS function named like {function} in {lib_path}")
    return counts


def profile_decode(label, step, steps=4):
    """Wall time of a decode step (host clock, no profiler) and the card's
    busy time in it by kernel (torch.profiler, a second window of steps);
    ``step(i)`` runs the i-th step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(steps + i)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    log(f"decode step profile ({label}, {steps} steps): "
        f"wall {wall_ms:.2f} ms a step, card busy {busy_ms:.2f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f}); {len(kernels)} kernel names")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / steps / 1e3:8.3f} ms a step, "
            f"{e.count / steps:6.1f} launches: {e.key[:90]}")


def ragged_prompts(rng, n, vocab):
    """n prompts of 5..32 tokens, right-padded to 32 columns."""
    lens = rng.integers(5, 33, size=n)
    lens[0] = 32
    ids = np.zeros((n, 32), dtype=np.int64)
    mask = np.zeros((n, 32), dtype=np.int64)
    prompts = []
    for i, L in enumerate(lens):
        p = rng.integers(2, vocab, size=L)
        prompts.append(p)
        ids[i, :L] = p
        mask[i, :L] = 1
    return prompts, ids, mask


# the kernels each main path must launch (and no other), by path
PATHS = {
    "generate": ("bfp_matmul_subbyte_t", "attn_decode_pos_major"),
    "ContinuousBatcher": ("bfp_matmul_int8", "attn_decode_head_major"),
    "opt_generate_t": ("bfp_matmul_subbyte_t",),
    "opt_generate_lane_major": ("bfp_matmul_subbyte",),
}
# the probe entry points: each probe kernel and the production kernels
# they print beside it
PROBE_PATHS = {
    "ksub": ("probe_subbyte_t", "probe_subbyte", "bfp_matmul_subbyte_t", "bfp_matmul_subbyte"),
    "kvariants": ("probe_matmul_variant_t", "probe_matmul_variant", "bfp_matmul_subbyte_t",
                  "bfp_matmul_subbyte"),
    "kvariants2": ("probe_sub_variant_t", "probe_sub_variant", "probe_int8_variant",
                   "bfp_matmul_subbyte_t", "bfp_matmul_subbyte", "bfp_matmul_int8"),
    "aprobe": ("probe_attention", "attn_decode_pos_major"),
    "kprobe": ("probe_subbyte_tile", "bfp_matmul_subbyte", "bfp_matmul_int8"),
    "ktune7b": ("probe_int8_tile", "probe_band_sum", "probe_subbyte_tile", "bfp_matmul_int8",
                "bfp_matmul_subbyte"),
}
_VARIANT_CU = "llm_mixed_q_torch/csrc/probes/variant_probe.cu"
_INT8_TILE_CU = "llm_mixed_q_torch/csrc/probes/int8_tile_probe.cu"
PROBE_SOURCES = {  # name: (source, the TPU probe's pallas_call)
    "probe_subbyte_t": ("llm_mixed_q_torch/csrc/probes/subbyte_probe.cu", "tools/ksub.py:225"),
    "probe_subbyte": ("llm_mixed_q_torch/csrc/probes/subbyte_probe.cu", "tools/ksub.py:270"),
    "probe_matmul_variant_t": (_VARIANT_CU, "tools/kvariants.py:130"),
    "probe_matmul_variant": (_VARIANT_CU, "tools/kvariants.py:130"),
    "probe_sub_variant_t": (_VARIANT_CU, "tools/kvariants2.py:170"),
    "probe_sub_variant": (_VARIANT_CU, "tools/kvariants2.py:170"),
    "probe_int8_variant": ("llm_mixed_q_torch/csrc/probes/int8_probe.cu", "tools/kvariants2.py:90"),
    "probe_attention": ("llm_mixed_q_torch/csrc/probes/attention_probe.cu", "tools/aprobe.py:122"),
    "probe_subbyte_tile": ("llm_mixed_q_torch/csrc/probes/subbyte_tile_probe.cu",
                           "tools/kprobe.py:66"),
    "probe_int8_tile": (_INT8_TILE_CU, "tools/ktune7b.py:100"),
    "probe_band_sum": (_INT8_TILE_CU, "tools/ktune7b.py:84"),
}
# the other TPU probes a kernel's instances replace (P7: subbyte_tile's tps;
# P5: int8_tile's bands, with band_sum)
PROBE_ALSO_REPLACES = {"probe_subbyte_tile": ["tools/ktune7b.py:174"],
                       "probe_int8_tile": ["tools/ktune7b.py:84"]}
# the variant whose numbers stand in a probe's row (every variant is under
# "variants")
PROBE_HEADS = {"probe_subbyte_t": "ship", "probe_subbyte": "ship",
               "probe_matmul_variant_t": "v2", "probe_matmul_variant": "v2",
               "probe_sub_variant_t": "v4_bf16s", "probe_sub_variant": "v4_bf16s",
               "probe_int8_variant": "int8_bf16s", "probe_attention": "quant/f32",
               "probe_subbyte_tile": "c32_t1", "probe_int8_tile": "c32_k512"}


def check_path_counts(path_counts):
    for path, counts in path_counts.items():
        log(f"launches of the {path} run: {counts}")
        for kname, c in counts.items():
            if kname in {**PATHS, **PROBE_PATHS}[path]:
                check(c > 0, f"kernel {kname} was not launched by the {path} run")
            else:
                check(c == 0, f"kernel {kname} was launched by the {path} run")


def run_llama():
    """Llama-2-7B widths: generate (K1 + K4), ContinuousBatcher (K2 + K5),
    decode steps against the plain path, a profiled step. -> launch counts
    by path. The trees are freed on return."""
    from llm_mixed_q_torch.models.hf_loader import init_llama_params
    from llm_mixed_q_torch.models.llama import (
        ContinuousBatcher, LlamaQuantizedConfig, decode_step, generate,
        prefill_into_cache)
    from llm_mixed_q_torch.models.llama.serving import (
        init_packed_kv_cache, kv_cache_pack_spec)

    config = LlamaQuantizedConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=INTER,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        max_position_embeddings=4096,
        quant_config=str(ROOT / "configs/quantization/bfp_6bit.toml"))
    t0 = time.perf_counter()
    sub = init_llama_params(config, seed=SEED, pack=dict(subbyte=True, bf16_embed=True))
    int8 = init_llama_params(config, seed=SEED, pack=dict(subbyte=False, bf16_embed=True))
    torch.cuda.synchronize()
    log(f"model: Llama-2-7B widths, {LAYERS} layers (depth not cut), W6A6 "
        f"block_fp, random weights seed {SEED}; init + pack of both formats "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")

    rng = np.random.default_rng(SEED)
    g_prompts, g_ids, g_mask = ragged_prompts(rng, BATCH, VOCAB)
    b_prompts, b_ids, b_mask = ragged_prompts(rng, 16, VOCAB)
    new_tokens = 32

    # each path runs with every launch count set to 0 just before it and
    # read just after it; the reference runs come after both readings
    path_counts = {}
    reset_all_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_tok = generate(sub, config, g_ids, g_mask, max_new_tokens=new_tokens, max_len=256)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    path_counts["generate"] = all_launch_counts()
    srv = ContinuousBatcher(int8, config, num_slots=8, max_len=512,
                            max_new_tokens=new_tokens, prompt_bucket=32)
    for p in b_prompts:
        srv.submit(p)
    reset_all_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = srv.run()
    torch.cuda.synchronize()
    t_srv = time.perf_counter() - t0
    path_counts["ContinuousBatcher"] = all_launch_counts()
    check_path_counts(path_counts)
    ref = np.concatenate([
        generate(int8, config, b_ids[i:i + 8], b_mask[i:i + 8],
                 max_new_tokens=new_tokens, max_len=512)
        for i in (0, 8)])
    check(g_tok.shape == (BATCH, new_tokens) and (g_tok >= 0).all() and (g_tok < VOCAB).all(),
          f"generate returned bad tokens {g_tok.shape}")
    check(all(len(outs[rid]) == new_tokens for rid in range(16)),
          "the batcher did not finish every request")
    mismatched = [rid for rid in range(16) if outs[rid] != ref[rid].tolist()]
    log(f"generate (sub-byte, pos-major, batch {BATCH}, max_len 256): "
        f"{BATCH * new_tokens / t_gen:.1f} tokens/s incl. prefill ({t_gen:.2f} s)")
    log(f"ContinuousBatcher (int8, head-major, 8 slots, max_len 512, 16 requests): "
        f"{16 * new_tokens / t_srv:.1f} tokens/s ({t_srv:.2f} s); requests whose "
        f"tokens differ from generate's rows: {mismatched}")

    # one decode step, kernel path against plain path, on the same cache
    for label, params in (("sub-byte", sub), ("int8", int8)):
        for max_len in (256, 512):
            spec = kv_cache_pack_spec(config)
            ids = torch.as_tensor(g_ids, device="cuda")
            mask = torch.as_tensor(g_mask, device="cuda")
            cache = init_packed_kv_cache(config, BATCH, max_len, spec, "cuda")
            logits, lengths = prefill_into_cache(params, ids, mask, cache, config)
            tok = torch.argmax(logits, -1)[:, None]
            snapshot = [[t.clone() for t in f] for f in cache[:4]]
            reset_all_launch_counts()
            got = decode_step(params, tok, cache, lengths, config)
            step_counts = all_launch_counts()
            cache2 = cache._replace(**dict(zip(
                ("k_codes", "k_scales", "v_codes", "v_scales"), snapshot)))
            with plain_path():
                want = decode_step(params, tok, cache2, lengths, config)
            check(all_launch_counts() == step_counts, "the plain path launched a kernel")
            log(f"launches in one decode step ({label}, max_len {max_len}): "
                f"{ {k: c for k, c in step_counts.items() if c} }")
            rel = ((got - want).abs().max() / want.abs().max()).item()
            agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
            log(f"decode step logits, kernel vs plain ({label}, max_len {max_len}): "
                f"max err {rel:.3e} of max|logit|, argmax agreement {agree:.3f}")
            # ulp-level differences of float32 sums flip a 5-bit rounding of
            # the re-quantized activations now and then; over 32 layers that
            # moves the logits by a few percent of their range at most
            check(rel <= 5e-2, f"decode logits differ: {rel}")

    check(not mismatched, f"batcher requests {mismatched} != generate rows")

    cache = init_packed_kv_cache(config, BATCH, 256, kv_cache_pack_spec(config), "cuda")
    logits, lengths = prefill_into_cache(sub, torch.as_tensor(g_ids, device="cuda"),
                                         torch.as_tensor(g_mask, device="cuda"), cache, config)
    tok = torch.argmax(logits, -1)[:, None]
    profile_decode(f"Llama sub-byte, batch {BATCH}, max_len 256",
                   lambda i: decode_step(sub, tok, cache, lengths + i, config))
    return path_counts


def run_opt():
    """OPT-6.7B widths, one tree packed as the package packs it (transposed
    sub-byte words: K1) and one left lane-major (``PackedBFPSub``: K3), from
    the same seed: generate on each with the launch counters reset and read
    around it, then a decode step of each against the plain path and a
    profiled window of steps. -> launch counts by path."""
    from llm_mixed_q_torch.kernels import (
        PackedBFPSub, PackedBFPSubT, transpose_subbyte)
    from llm_mixed_q_torch.models import pack_common
    from llm_mixed_q_torch.models.hf_loader import init_opt_params
    from llm_mixed_q_torch.models.opt import OPTQuantizedConfig, opt_generate
    from llm_mixed_q_torch.models.opt.serving import (
        decode_step, init_kv_cache, prefill_into_cache)

    config = OPTQuantizedConfig(
        vocab_size=OPT_VOCAB, hidden_size=OPT_HIDDEN, ffn_dim=OPT_FFN,
        num_hidden_layers=OPT_LAYERS, num_attention_heads=OPT_HEADS,
        max_position_embeddings=2048, word_embed_proj_dim=OPT_HIDDEN,
        do_layer_norm_before=True, activation_function="relu", enable_bias=True,
        quant_config=str(ROOT / "configs/quantization/bfp_6bit.toml"))
    t0 = time.perf_counter()
    trees = {"opt_generate_t": init_opt_params(config, seed=SEED, pack=dict(subbyte=True))}
    # the package has no switch for the lane-major layout: every packer
    # transposes (pack_common._to_t); the identity in its place leaves the
    # PackedBFPSub words that K3 reads
    with mock.patch.object(pack_common, "_to_t", lambda p: p):
        trees["opt_generate_lane_major"] = init_opt_params(config, seed=SEED,
                                                           pack=dict(subbyte=True))
    torch.cuda.synchronize()
    log(f"model: OPT-6.7B widths, {OPT_LAYERS} layers (depth not cut), W6A6 "
        f"block_fp, random weights seed {SEED}; init + pack of both layouts "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    for layer_t, layer_l in zip(trees["opt_generate_t"]["layers"],
                                trees["opt_generate_lane_major"]["layers"]):
        for wt, wl in ((layer_t["fc1"]["weight"], layer_l["fc1"]["weight"]),
                       (layer_t["self_attn"]["q_proj"]["weight"],
                        layer_l["self_attn"]["q_proj"]["weight"])):
            check(isinstance(wt, PackedBFPSubT) and isinstance(wl, PackedBFPSub),
                  "the OPT trees do not hold the two sub-byte layouts")
            tl = transpose_subbyte(wl)
            check(torch.equal(tl.words, wt.words) and torch.equal(tl.scales, wt.scales),
                  "the lane-major codes differ from the transposed tree's")

    rng = np.random.default_rng(SEED + 1)
    _, ids, mask = ragged_prompts(rng, BATCH, OPT_VOCAB)
    new_tokens, max_len = 32, 64
    path_counts, tokens, seconds = {}, {}, {}
    for path, params in trees.items():
        reset_all_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens[path] = opt_generate(params, config, ids, mask, max_new_tokens=new_tokens,
                                    max_len=max_len)
        torch.cuda.synchronize()
        seconds[path] = time.perf_counter() - t0
        path_counts[path] = all_launch_counts()
        tok = tokens[path]
        check(tok.shape == (BATCH, new_tokens) and (tok >= 0).all() and (tok < OPT_VOCAB).all(),
              f"OPT generate returned bad tokens {tok.shape}")
    check_path_counts(path_counts)
    differ = int((tokens["opt_generate_t"] != tokens["opt_generate_lane_major"]).sum())
    for path in trees:
        log(f"OPT generate ({path}, batch {BATCH}, max_len {max_len}): "
            f"{BATCH * new_tokens / seconds[path]:.1f} tokens/s incl. prefill "
            f"({seconds[path]:.2f} s)")
    log(f"OPT generate: tokens where the K1 and K3 trees differ: {differ} of "
        f"{BATCH * new_tokens}")

    ids_t = torch.as_tensor(ids, device="cuda")
    mask_t = torch.as_tensor(mask, device="cuda")
    for path, params in trees.items():
        cache = init_kv_cache(config, BATCH, max_len, "cuda")
        logits, lengths = prefill_into_cache(params, ids_t, mask_t, cache, config)
        tok = torch.argmax(logits, -1)[:, None]
        cache2 = cache.clone()
        reset_all_launch_counts()
        got = decode_step(params, tok, cache, lengths, config)
        step_counts = all_launch_counts()
        with plain_path():
            want = decode_step(params, tok, cache2, lengths, config)
        check(all_launch_counts() == step_counts, "the plain path launched a kernel")
        log(f"launches in one OPT decode step ({path}): "
            f"{ {k: c for k, c in step_counts.items() if c} }")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        log(f"OPT decode step logits, kernel vs plain ({path}): max err {rel:.3e} "
            f"of max|logit|, argmax agreement {agree:.3f}")
        check(rel <= 5e-2, f"OPT decode logits differ: {rel}")
        profile_decode(f"OPT {path}, batch {BATCH}, max_len {max_len}",
                       lambda i: decode_step(params, tok, cache, lengths + 1 + i, config))
    return path_counts

def _close_to_max(got, want, tol, what):
    """Fail unless max|got - want| <= tol * max|want|; -> max abs error."""
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    check(rel <= tol, f"{what}: rel err {rel:.3e} > {tol}")
    return err


def _add(d, key, value):
    d[key] = d.get(key, 0.0) + value


def check_subbyte_probes(peaks, flush):
    """P8 (K1's layout) and P9 (K3's) at the four Llama-2-7B projection
    shapes, M = 8: every variant against its plain version (1e-4 of max|y|,
    float32 sums in another order), its plain time and bounds (operations
    at the peak of the units the copy runs on), one bf16 matmul on the
    pre-dequantized weight as ship's yardstick; then the copy's
    faithfulness: ship on bf16 x equals the production kernel with no
    activation quantizer (its lo term is then 0: the same product), timed
    beside it and beside the production kernel with ACTQ. -> {probe: row},
    sums over the four shapes."""
    from llm_mixed_q_torch.kernels.dequant_matmul import (
        _k_padded, bfp_matmul_subbyte_cuda, bfp_matmul_subbyte_t_cuda)
    from llm_mixed_q_torch.kernels.packing import (
        pack_block_fp_subbyte, packed_nbytes, transpose_subbyte, unpack)
    from llm_mixed_q_torch.tools import ksub
    from llm_mixed_q_torch.tools.timing import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    probes = {  # name: (layout of the packed weight, production kernel, its name, op peak)
        "probe_subbyte_t": (transpose_subbyte, bfp_matmul_subbyte_t_cuda, "K1", peaks[2]),
        "probe_subbyte": (lambda p: p, bfp_matmul_subbyte_cuda, "K3", peaks[1]),
    }
    rows = {name: {"variants": {v: {"max_abs_err": 0.0, "library_ms": None}
                                for v in ksub.VARIANTS}, "beside_ms": {}}
            for name in probes}
    for sname, (n, k) in ksub.SHAPES.items():
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        lane_major = pack_block_fp_subbyte(w, ksub.WIDTH, 8, 127, [1, ksub.BLOCK])
        del w
        k_pad = _k_padded(lane_major)
        x = torch.randn((ksub.M, k_pad), generator=gen, device="cuda")
        xk = x[:, :k].contiguous()
        x_bf = xk.to(torch.bfloat16).float()
        for name, (layout, prod, pname, op_peak) in probes.items():
            packed, row = layout(lane_major), rows[name]
            nbytes = packed_nbytes(packed) + 4 * ksub.M * (k_pad + n)
            for v in ksub.VARIANTS:
                rv = row["variants"][v]
                err = _close_to_max(ksub.subbyte_probe(x, packed, v),
                                    ksub.subbyte_probe_plain(x, packed, v), 1e-4,
                                    f"{name} {v} {sname}")
                rv["max_abs_err"] = max(rv["max_abs_err"], err)
                _add(rv, "plain_ms", cuda_ms(lambda: ksub.subbyte_probe_plain(x, packed, v),
                                             reps=3, flush=flush))
                k_ops = k_pad // packed.per_word if v == "stream" else k_pad
                _add(rv, "bound_bytes_ms", nbytes / peaks[0] * 1e3)
                _add(rv, "bound_ops_ms", 2 * ksub.M * n * k_ops / op_peak * 1e3)
            w_bf16, x16 = unpack(packed, torch.bfloat16), xk.to(torch.bfloat16)
            rv = row["variants"]["ship"]
            rv["library_ms"] = (rv["library_ms"] or 0.0) + cuda_ms(
                lambda: torch.matmul(x16, w_bf16.t()), flush=flush)
            del w_bf16
            err = _close_to_max(ksub.subbyte_probe(x_bf, packed, "ship"), prod(x_bf, packed, None),
                                1e-4, f"{name} ship vs {pname} {sname}")
            times = {"ship": cuda_ms(lambda: ksub.subbyte_probe(x_bf, packed, "ship"), flush=flush),
                     pname: cuda_ms(lambda: prod(x_bf, packed, None), flush=flush),
                     f"{pname} actq": cuda_ms(lambda: prod(xk, packed, ACTQ), flush=flush)}
            for key, t in times.items():
                _add(row["beside_ms"], key, t)
            log(f"  {name} {sname} N={n} K={k}: ship == {pname} without actq on bf16 x "
                f"(max abs err {err:.3e}); ms " + ", ".join(f"{key} {t:.4f}" for key, t in times.items()))
    return rows


def check_attention_probe(peaks, flush):
    """P11 at the TPU probe's shape (b = 32, S = 256, nh = nkv = 32, hd = 128,
    every position filled, inputs from seed 0, q quantized as the serving
    path quantizes it, so the scores are exact in float32 whatever the order
    of their sums, as in K4's check): every stage and dot type against its
    plain version (dma, dequant: bit-exact; matmul: 1e-4 of max|ctx| with
    float32 dots, 1e-3 with bf16 dots; softmax, quant: rtol 2e-4 / atol
    2e-5), its plain time and bound; SDPA on a dequantized float32 cache as
    the quant stage's yardstick (as K4's); then the quant stage with float32
    dots against K4, timed beside it. -> row."""
    from llm_mixed_q_torch.kernels.attention_decode import packed_attention_decode_batch_cuda
    from llm_mixed_q_torch.ops.quantizers import _block_fp_qdq
    from llm_mixed_q_torch.tools import aprobe
    from llm_mixed_q_torch.tools.timing import cuda_ms

    b, s_len, hd, nkv = 32, 256, aprobe.HD, aprobe.NKV
    q, kc, ks, vc, vs, pos = aprobe.make_inputs(b, s_len, device="cuda")
    q = _block_fp_qdq(q.reshape(-1, hd), *ACTQ[1:], [1, ACTQ[0]], True).reshape(q.shape)
    inputs = (q, kc, ks, vc, vs, pos)
    nbytes = sum(t.numel() * t.element_size() for t in inputs[1:5]) + 8 * q.numel() + 4 * b
    row = {"variants": {}}
    for stage in aprobe.STAGES:
        for dot in aprobe.DOTS[stage]:
            label = f"{stage}/{dot}"
            run = lambda: aprobe.attention_probe(*inputs, stage, dot)
            plain = lambda: aprobe.attention_probe_plain(*inputs, stage, dot)
            got, want = run(), plain()
            if stage in ("dma", "dequant"):
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"probe_attention {label}: not q")
                err = 0.0
            elif stage == "matmul":
                err = _close_to_max(got, want, 1e-4 if dot == "f32" else 1e-3,
                                    f"probe_attention {label}")
            else:
                err = (got - want).abs().max().item()
                check(torch.allclose(got, want, rtol=2e-4, atol=2e-5),
                      f"probe_attention {label}: max err {err}")
            cols = b * aprobe.NH * (s_len * nkv if stage == "matmul" else s_len)
            flops = 0 if stage in ("dma", "dequant") else 4 * hd * cols
            b_ms, b_by = bound(nbytes, flops, peaks)
            row["variants"][label] = dict(max_abs_err=err, plain_ms=cuda_ms(plain, reps=3, flush=flush),
                                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
            log(f"  probe_attention {label}: max_abs_err={err:.3e} bound_ms={b_ms:.4f} ({b_by}) "
                f"plain_ms={row['variants'][label]['plain_ms']:.4f}")
    kd = torch.randn((b, nkv, s_len, hd), device="cuda")
    vd = torch.randn_like(kd)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q.reshape(b, nkv, 1, hd), kd, vd), flush=flush)
    for dot in aprobe.DOTS["quant"]:
        row["variants"][f"quant/{dot}"]["library_ms"] = library_ms
    k4 = lambda: packed_attention_decode_batch_cuda(
        q, kc, ks, vc, vs, pos, aprobe.BSK, aprobe.BSV, nkv=nkv, rep=aprobe.REP,
        prob_q=aprobe.PROB_Q)
    got, want = aprobe.attention_probe(*inputs, "quant"), k4()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=2e-4, atol=2e-5), f"quant/f32 vs K4: max err {err}")
    row["beside_ms"] = {"quant/f32": cuda_ms(lambda: aprobe.attention_probe(*inputs, "quant"),
                                             flush=flush), "K4": cuda_ms(k4, flush=flush)}
    log(f"  probe_attention quant/f32 == K4 (max abs err {err:.3e}); ms "
        + ", ".join(f"{key} {t:.4f}" for key, t in row["beside_ms"].items()))
    return row


def check_variant_probes(peaks, flush):
    """P1 (v2, v3) and P3 (v4_f32s, v4_bf16s) in K1's and K3's layouts, and
    P2 (int8_f32s, int8_bf16s), at the four Llama-2-7B projection shapes,
    M = 8: every variant against its plain version (1e-4 of max|y|: float32
    sums in another order, v3's correction cancelling against a sum that
    grows with K), its plain time and bounds (the scales at their stored
    size: 1, 2 or 4 bytes a block; operations at the peak of the units the
    copy runs on), one bf16 matmul on the pre-dequantized weight as every
    variant's yardstick (each computes x . W); then faithfulness on bf16 x
    without activation quantizer: v2 and v4 equal K1/K3 and P2 equals K2 to
    max abs error 0, v3 is within 1e-5 of max|y|; the production kernels
    timed beside them. -> {probe: row}, sums over the four shapes."""
    from llm_mixed_q_torch.kernels.dequant_matmul import (
        _k_padded, bfp_matmul_cuda, bfp_matmul_subbyte_cuda, bfp_matmul_subbyte_t_cuda)
    from llm_mixed_q_torch.kernels.packing import (
        pack_block_fp, pack_block_fp_subbyte, transpose_subbyte, unpack)
    from llm_mixed_q_torch.tools import ksub
    from llm_mixed_q_torch.tools import kvariants as kv
    from llm_mixed_q_torch.tools import kvariants2 as kv2
    from llm_mixed_q_torch.tools.timing import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    sub = {v: (kv2.sub_variant, kv2.sub_variant_plain, dt) for dt, v in kv2.SUB_VARIANTS.items()}
    mm = {v: (kv.matmul_variant, kv.matmul_variant_plain, v) for v in kv.VARIANTS}
    probes = {}  # name: (format, production kernel, its name, op peak, {variant: (fn, plain, arg)})
    for suffix, fmt, prod, pname, op_peak in (
            ("_t", "transposed", bfp_matmul_subbyte_t_cuda, "K1", peaks[2]),
            ("", "lane_major", bfp_matmul_subbyte_cuda, "K3", peaks[1])):
        probes["probe_matmul_variant" + suffix] = (fmt, prod, pname, op_peak, mm)
        probes["probe_sub_variant" + suffix] = (fmt, prod, pname, op_peak, sub)
    probes["probe_int8_variant"] = ("int8", bfp_matmul_cuda, "K2", peaks[1], {
        v: (kv2.int8_variant, kv2.int8_variant_plain, dt) for dt, v in kv2.INT8_VARIANTS.items()})
    rows = {name: {"variants": {v: {"max_abs_err": 0.0} for v in spec[4]}, "beside_ms": {}}
            for name, spec in probes.items()}
    for sname, (n, k) in ksub.SHAPES.items():
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        lane_major = pack_block_fp_subbyte(w, ksub.WIDTH, 8, 127, [1, ksub.BLOCK])
        packs = {"lane_major": lane_major, "transposed": transpose_subbyte(lane_major),
                 "int8": pack_block_fp(w, ksub.WIDTH, 8, 127, [1, ksub.BLOCK])}
        del w
        x = torch.randn((ksub.M, k), generator=gen, device="cuda")
        x_bf, x16 = x.to(torch.bfloat16).float(), x.to(torch.bfloat16)
        library, prod_ms = {}, {}
        for fmt in ("lane_major", "int8"):
            w_bf16 = unpack(packs[fmt], torch.bfloat16)
            library[fmt] = cuda_ms(lambda: torch.matmul(x16, w_bf16.t()), flush=flush)
            del w_bf16
        for name, (fmt, prod, pname, op_peak, variants) in probes.items():
            packed, row = packs[fmt], rows[name]
            k_pad = packed.codes.shape[1] if fmt == "int8" else _k_padded(packed)
            want = prod(x_bf, packed, None)
            for v, (fn, plain, arg) in variants.items():
                rv = row["variants"][v]
                # P3's and P2's scales stored as the kernel reads them, outside the timed calls
                op = packed if fn is kv.matmul_variant else kv2.stored_scales(packed, arg)
                err = _close_to_max(fn(x, op, arg), plain(x, op, arg), 1e-4, f"{name} {v} {sname}")
                rv["max_abs_err"] = max(rv["max_abs_err"], err)
                _add(rv, "plain_ms", cuda_ms(lambda: plain(x, op, arg), reps=3, flush=flush))
                _add(rv, "library_ms", library["int8" if fmt == "int8" else "lane_major"])
                nbytes = kv2.stored_nbytes(op) + 4 * ksub.M * (k + n)
                flops = 2 * ksub.M * n * k_pad
                if v == "v3":  # the block sums and the correction
                    flops += ksub.M * k_pad + 2 * ksub.M * n * (k_pad // packed.block_size)
                _add(rv, "bound_bytes_ms", nbytes / peaks[0] * 1e3)
                _add(rv, "bound_ops_ms", flops / op_peak * 1e3)
                got = fn(x_bf, op, arg)
                if v == "v3":
                    err = _close_to_max(got, want, 1e-5, f"{name} v3 vs {pname} {sname}")
                else:
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    check(err == 0.0, f"{name} {v} vs {pname} {sname}: max abs err {err}")
                log(f"  {name} {sname} N={n} K={k}: {v} vs {pname} without actq on bf16 x: "
                    f"max abs err {err:.3e}; plain version {rv['max_abs_err']:.3e} so far")
            if (fmt, sname) not in prod_ms:
                prod_ms[fmt, sname] = cuda_ms(lambda: prod(x_bf, packed, None), flush=flush)
            _add(row["beside_ms"], pname, prod_ms[fmt, sname])
        del packs, lane_major
    return rows


def check_tile_probes(peaks, flush):
    """P4/P7 (subbyte_tile, lane-major sub-byte) and P6/P5 (int8_tile) at the
    four Llama-2-7B projection shapes, M = 8: every instance against its
    plain version (1e-4 of max|y|, float32 sums in another order), the plain
    version's time (one a shape, shared by the instances whose plain version
    is the same product: all but the band's), bounds (the weight as stored,
    x and y, and a band instance's workspace written and read; operations at
    the float32 peak), one bf16 matmul on the pre-dequantized weight as the
    yardstick; then faithfulness on bf16 x without activation quantizer:
    every subbyte_tile instance equals K3 and every int8_tile instance
    without bands K2 to max abs error 0, the band instance within 1e-5 of
    max|y|. band_sum, on a workspace of the band instance's shape: equal to
    its plain version, timed alone beside ``ws.sum(0)``. -> {probe: row},
    sums over the four shapes."""
    from llm_mixed_q_torch.kernels.dequant_matmul import (
        _k_padded, bfp_matmul_cuda, bfp_matmul_subbyte_cuda)
    from llm_mixed_q_torch.kernels.packing import (
        pack_block_fp, pack_block_fp_subbyte, packed_nbytes, unpack)
    from llm_mixed_q_torch.tools import kprobe, ksub, ktune7b
    from llm_mixed_q_torch.tools.timing import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    probes = {  # name: (format, instances, kernel, plain version, production kernel, its name)
        "probe_subbyte_tile": ("sub", kprobe.SUB_INSTANCES, kprobe.subbyte_tile,
                               kprobe.subbyte_tile_plain, bfp_matmul_subbyte_cuda, "K3"),
        "probe_int8_tile": ("int8", ktune7b.INT8_INSTANCES, ktune7b.int8_tile,
                            ktune7b.int8_tile_plain, bfp_matmul_cuda, "K2"),
    }
    rows = {name: {"variants": {v: {"max_abs_err": 0.0, "faithful_err": 0.0}
                                for v in spec[1]}} for name, spec in probes.items()}
    band = {"max_abs_err": 0.0}
    m = ksub.M
    for sname, (n, k) in ksub.SHAPES.items():
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        packs = {"sub": pack_block_fp_subbyte(w, ksub.WIDTH, 8, 127, [1, ksub.BLOCK]),
                 "int8": pack_block_fp(w, ksub.WIDTH, 8, 127, [1, ksub.BLOCK])}
        del w
        x = torch.randn((m, k), generator=gen, device="cuda")
        x_bf, x16 = x.to(torch.bfloat16).float(), x.to(torch.bfloat16)
        for name, (fmt, instances, fn, plain, prod, pname) in probes.items():
            packed = packs[fmt]
            k_pad = packed.codes.shape[1] if fmt == "int8" else _k_padded(packed)
            w_bf16 = unpack(packed, torch.bfloat16)
            library = cuda_ms(lambda: torch.matmul(x16, w_bf16.t()), flush=flush)
            del w_bf16
            want = prod(x_bf, packed, None)
            plain_ms = {}
            for v, args in instances.items():
                rv = rows[name]["variants"][v]
                err = _close_to_max(fn(x, packed, *args), plain(x, packed, *args), 1e-4,
                                    f"{name} {v} {sname}")
                rv["max_abs_err"] = max(rv["max_abs_err"], err)
                band_k = args[2] if fmt == "int8" else None
                if band_k not in plain_ms:
                    plain_ms[band_k] = cuda_ms(lambda: plain(x, packed, *args), reps=3, flush=flush)
                _add(rv, "plain_ms", plain_ms[band_k])
                _add(rv, "library_ms", library)
                ws_bytes = 2 * -(-k_pad // band_k) * m * n * 4 if band_k else 0
                _add(rv, "bound_bytes_ms",
                     (packed_nbytes(packed) + 4 * m * (k + n) + ws_bytes) / peaks[0] * 1e3)
                _add(rv, "bound_ops_ms", 2 * m * n * k_pad / peaks[1] * 1e3)
                got = fn(x_bf, packed, *args)
                if band_k:
                    err = _close_to_max(got, want, 1e-5, f"{name} {v} vs {pname} {sname}")
                else:
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    check(err == 0.0, f"{name} {v} vs {pname} {sname}: max abs err {err}")
                rv["faithful_err"] = max(rv["faithful_err"], err)
            log(f"  {name} {sname} N={n} K={k}: every instance within 1e-4 of its plain version "
                f"(max abs err {max(r['max_abs_err'] for r in rows[name]['variants'].values()):.3e}"
                f" so far), == {pname} without actq on bf16 x (bands: "
                f"{max(r['faithful_err'] for r in rows[name]['variants'].values()):.3e})")
        # band_sum on a workspace of the band instance's shape
        bands = -(-packs["int8"].codes.shape[1] // 1024)
        ws = torch.randn((bands, m, n), generator=gen, device="cuda")
        got = ktune7b.band_sum(ws)
        torch.cuda.synchronize()
        check(torch.equal(got, ktune7b.band_sum_plain(ws)), f"band_sum {sname}: not its plain version")
        for key, call in (("ms", lambda: ktune7b.band_sum(ws)),
                          ("plain_ms", lambda: ktune7b.band_sum_plain(ws)),
                          ("library_ms", lambda: ws.sum(0))):
            _add(band, key, cuda_ms(call, flush=flush))
        _add(band, "bound_bytes_ms", (bands + 1) * m * n * 4 / peaks[0] * 1e3)
        _add(band, "bound_ops_ms", (bands - 1) * m * n / peaks[1] * 1e3)
        del packs
    rows["probe_band_sum"] = band
    return rows


def _bound_of(r):
    """Set r's bound_ms and bound_by from its summed bytes and operations
    bounds."""
    by_bytes = r["bound_bytes_ms"] >= r["bound_ops_ms"]
    r["bound_ms"] = max(r.pop("bound_bytes_ms"), r.pop("bound_ops_ms"))
    r["bound_by"] = "bytes" if by_bytes else "operations"


def run_probes(peaks, flush):
    """Phase 7: the probe kernels against their plain versions and their
    production kernels, then the six probe entry points, each with the
    launch counters set to 0 before it and read after it. -> (probe rows,
    launch counts by probe path)."""
    from llm_mixed_q_torch.tools import aprobe, kprobe, ksub, ktune7b, kvariants, kvariants2

    t0 = time.perf_counter()
    log("probe kernels vs plain versions and vs their production kernels:")
    rows = check_subbyte_probes(peaks, flush)
    rows.update(check_variant_probes(peaks, flush))
    rows["probe_attention"] = check_attention_probe(peaks, flush)
    rows.update(check_tile_probes(peaks, flush))

    counts, times = {}, {}
    for path, run in (("ksub", lambda: ksub.run(ksub.SHAPES, reps=3, log=log)),
                      ("kvariants", lambda: kvariants.run(ksub.SHAPES, reps=3, log=log)),
                      ("kvariants2", lambda: kvariants2.run(ksub.SHAPES, reps=3, log=log)),
                      ("aprobe", lambda: aprobe.run(32, 256, reps=3, log=log)),
                      ("kprobe", lambda: kprobe.run(ksub.SHAPES, reps=3, log=log)),
                      ("ktune7b", lambda: ktune7b.run(ksub.SHAPES, reps=3, log=log))):
        reset_all_launch_counts()
        torch.cuda.synchronize()
        times[path] = run()
        torch.cuda.synchronize()
        counts[path] = all_launch_counts()
    check_path_counts(counts)

    # ms of each (probe, variant): sums over the four shapes of the entry
    # points' chains; production: the kernel the entry point prints beside it
    sources = {"probe_subbyte_t": ("ksub", "transposed"), "probe_subbyte": ("ksub", "lane_major"),
               "probe_matmul_variant_t": ("kvariants", "transposed"),
               "probe_matmul_variant": ("kvariants", "lane_major"),
               "probe_sub_variant_t": ("kvariants2", "transposed"),
               "probe_sub_variant": ("kvariants2", "lane_major"),
               "probe_int8_variant": ("kvariants2", "int8")}
    for name, (path, key) in sources.items():
        for v, rv in rows[name]["variants"].items():
            rv["ms"] = sum(t[key][v] for t in times[path].values())
            _bound_of(rv)
        prod_key = "K2" if key == "int8" else "production"
        label = "production with actq" if path == "ksub" else "production without actq"
        rows[name]["beside_ms"][f"{label}, {path} run"] = sum(
            t[key][prod_key] for t in times[path].values())
    for label, rv in rows["probe_attention"]["variants"].items():
        rv["ms"] = times["aprobe"][label]
    rows["probe_attention"]["beside_ms"]["K4, aprobe run"] = times["aprobe"]["K4"]
    # the tiling probes: an instance's ms from the first entry point that
    # runs it (P4's in kprobe, P7's and P6/P5's in ktune7b), with its steps,
    # blocks and blocks an SM at each shape; beside: the production kernels
    # and the yardstick in each run
    for name, fmt, prod in (("probe_subbyte_tile", "sub", "K3"), ("probe_int8_tile", "int8", "K2")):
        row = rows[name]
        row["beside_ms"] = {}
        for path in ("kprobe", "ktune7b"):
            shapes = times[path].values()
            for v, rv in row["variants"].items():
                if v in next(iter(shapes))[fmt]:
                    if "ms" in rv:
                        row["beside_ms"][f"{v}, {path} run"] = sum(t[fmt][v] for t in shapes)
                        continue
                    rv["ms"] = sum(t[fmt][v] for t in shapes)
                    rv["entry_point"] = path
                    for key in ("steps", "blocks", "per_sm"):
                        rv[key] = {s: t[key][v] for s, t in times[path].items()}
            for key in (prod, prod + "_actq", "bf16"):
                f = "bf16" if key == "bf16" else fmt
                row["beside_ms"][f"{key}, {path} run"] = sum(t[f][key] for t in shapes)
        for rv in row["variants"].values():
            _bound_of(rv)
    _bound_of(rows["probe_band_sum"])
    for name, row in rows.items():
        if "variants" not in row:
            continue
        head = row["variants"][PROBE_HEADS[name]]
        row.update({key: head.get(key) for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms")})
        row["max_abs_err"] = max(rv["max_abs_err"] for rv in row["variants"].values())
    log(f"phase 7 (probes) took {time.perf_counter() - t0:.1f} s")
    return rows, counts


def kernel_entries(rows, path_counts):
    """The entries of the ``{"kernels": ...}`` line. launches: the sum over
    the runs that take the kernel (serving paths for K1-K5, the probe
    entry points for the probes), each counted from 0 around its own run."""
    matmul_cu = "llm_mixed_q_torch/csrc/dequant_matmul.cu"
    attention_cu = "llm_mixed_q_torch/csrc/attention_decode.cu"
    sources = {"bfp_matmul_subbyte_t": (matmul_cu, "llm_mixed_q_tpu/kernels/dequant_matmul.py:349"),
               "bfp_matmul_int8": (matmul_cu, "llm_mixed_q_tpu/kernels/dequant_matmul.py:118"),
               "bfp_matmul_subbyte": (matmul_cu, "llm_mixed_q_tpu/kernels/dequant_matmul.py:221"),
               "attn_decode_pos_major": (attention_cu,
                                         "llm_mixed_q_tpu/kernels/attention_decode.py:190"),
               "attn_decode_head_major": (attention_cu,
                                          "llm_mixed_q_tpu/kernels/attention_decode.py:352"),
               **PROBE_SOURCES}
    kernels = []
    for kname, r in rows.items():
        src, replaces = sources[kname]
        if kname in PROBE_SOURCES:  # every run's count: 0 on the serving paths
            by_path = {p: c[kname] for p, c in path_counts.items()}
            launches = sum(c for p, c in by_path.items() if p in PROBE_PATHS)
        else:
            by_path = {p: path_counts[p][kname] for p, names in PATHS.items() if kname in names}
            launches = sum(by_path.values())
        extra = {key: r[key] for key in (
            "prefill_ms", "prefill_bound_ms", "prefill_bound_by", "prefill_library_ms",
            "opt_mlp_ms", "opt_mlp_prefill_ms", "variants", "beside_ms") if key in r}
        if kname in PROBE_ALSO_REPLACES:
            extra["also_replaces"] = PROBE_ALSO_REPLACES[kname]
        kernels.append(dict(name=kname, route="cuda", source=src, replaces=replaces,
                            path=", ".join(p for p, c in by_path.items() if c), launches=launches,
                            launches_by_path=by_path, max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"], **extra))
    return kernels

def main(k1_only=False, probes_only=False):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    if not (ROOT / "llm_mixed_q_torch").is_dir():
        print(f"chip_smoke: no llm_mixed_q_torch package beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    from llm_mixed_q_torch.kernels import _cuda
    from llm_mixed_q_torch.tools.timing import card_peaks

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    log(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"peaks used for bounds: {peaks[0] / 1e12} TB/s, {peaks[1] / 1e12} "
        f"TFLOP/s float32, {peaks[2] / 1e12} TFLOP/s bf16 tensor cores")
    log(f"nvidia-smi name, power limit: {smi}")

    t0 = time.perf_counter()
    libs = dict(zip(("kernels", "probes"), _cuda.build_all(("kernels", "probes"))))
    for lib_name in libs:
        _cuda.lib(lib_name)
        secs = _cuda.BUILD_SECONDS.get(lib_name)
        built = (f"built here, nvcc {secs:.1f} s" if secs
                 else "library already built from these sources")
        log(f"{lib_name} library: {built}")
        for line in _cuda.build_log(lib_name).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())
    log(f"both libraries built and loaded in {time.perf_counter() - t0:.1f} s")
    hmma = {**count_sass(libs["kernels"], "subbyte_t_kernel", "HMMA"),
            **count_sass(libs["probes"], "probe_t_kernel", "HMMA")}
    log(f"HMMA instructions in K1's and P8's SASS: {hmma}")

    flush_buf = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    flush = lambda: flush_buf.zero_()
    if k1_only:
        # K1's times alone, for comparing two versions of it in one call
        log(f"K1 vs its plain version at 7B decode shapes, batch {BATCH} and {PREFILL_M} rows:")
        log(json.dumps(check_matmul_kernels(peaks, flush, only="bfp_matmul_subbyte_t")))
        return
    check(all(hmma.values()), f"K1 or P8 does not run on the tensor cores: {hmma}")
    if probes_only:
        rows, path_counts = run_probes(peaks, flush)
        log(json.dumps({"kernels": kernel_entries(rows, path_counts)}))
        return
    log(f"kernels vs plain versions at 7B decode shapes, batch {BATCH} (K1 also "
        f"{PREFILL_M} rows):")
    rows = check_matmul_kernels(peaks, flush)
    rows.update(check_attention_kernels(peaks, flush))
    for r in rows.values():
        for pre in ("", "prefill_"):
            if pre + "bound_bytes_ms" in r:
                r[pre + "bound_ms"] = max(r[pre + "bound_bytes_ms"], r[pre + "bound_ops_ms"])
                r[pre + "bound_by"] = ("bytes" if r[pre + "bound_bytes_ms"] >= r[pre + "bound_ops_ms"]
                                       else "operations")

    path_counts = run_llama()
    torch.cuda.empty_cache()
    path_counts.update(run_opt())
    torch.cuda.empty_cache()
    probe_rows, probe_counts = run_probes(peaks, flush)
    rows.update(probe_rows)
    path_counts.update(probe_counts)

    log("(matmul rows: sums over one Llama-2-7B layer's four projections at batch "
        "8, opt_mlp_ms: OPT-6.7B fc1 and fc2 at batch 8; attention rows: one call "
        "at batch 8, 32 heads; probe rows: P8/P9/P1/P3/P2/P4-P7 sums over the four "
        "projections at M = 8, ms of ship (P8/P9), v2 (P1), v4_bf16s (P3), "
        "int8_bf16s (P2), c32_t1 (P4/P7), c32_k512 (P6/P5), band_sum one call a "
        "shape, P11 one call at b = 32, S = 256, ms of quant/f32; every variant under "
        "variants)")
    print(json.dumps({"kernels": kernel_entries(rows, path_counts)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(k1_only="--k1-only" in sys.argv[1:], probes_only="--probes-only" in sys.argv[1:])
