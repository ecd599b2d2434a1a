"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole run
    python3 chip_smoke.py --k1-only       # build, then K1's checks and times only
    python3 chip_smoke.py --k2-only       # build, then K2's and actq_split's only
    python3 chip_smoke.py --k3-only       # build, then K3's checks and times only
    python3 chip_smoke.py --k4-only       # build, then K4's checks and times only
    python3 chip_smoke.py --k5-only       # build, then K5's checks and times only,
                                          # and its times at other chunk and tile lengths
    python3 chip_smoke.py --m-sweep       # build, then K1, K2 and K3 over M only
    python3 chip_smoke.py --probes-only   # build, then the probe phase (9) only
    python3 chip_smoke.py --ppl-only      # the perplexity phase (7) only (no build)
    python3 chip_smoke.py --qat-only      # the QAT phase (8) only (no build)
    python3 chip_smoke.py --tail-only     # build, then the serving-tail and BERT phase (10) only
    python3 chip_smoke.py --stats-only    # build, then the statistics phase (11) only
    python3 chip_smoke.py --search-only   # build, then the search and prompting phase (12) only
    python3 chip_smoke.py --parallel-only # build, then the parallel phase (13) only
    python3 chip_smoke.py --scripts-only  # build, then the root scripts' phase (14) only

1. builds the Hopper kernels from ``llm_mixed_q_torch/csrc`` and the probe
   kernels from ``llm_mixed_q_torch/csrc/probes`` (two libraries, every
   nvcc started at once, sm_90a) and counts the HMMA (tensor-core)
   instructions of K1's, K2's, K3's and P8's SASS (``cuobjdump -sass``; the
   whole run fails if there are none);
2. holds each kernel against its plain PyTorch version on the card at the
   Llama-2-7B decode shapes (batch 8; the matmuls also at the 256 rows of a
   prefill; the sub-byte matmuls K1 and K3 also at the OPT-6.7B fc1/fc2
   shapes) and times kernel, plain version, library yardstick and the
   memory/compute bound (the matmuls K1, K2 and K3 also at 256 rows,
   ``prefill_*``; their operations bound at the bf16 tensor-core peak, the
   others' at the float32 one); K4 at four shapes (``K4_SHAPES``: the
   cache nearly full, every position at 31 as in ``generate``, GQA at
   8192 lanes, and rep 8 at 8192 lanes) and K5 at five (``K5_SHAPES``: the
   batcher's 512 positions nearly full and where the batcher decodes, 4096
   positions at 32 kv heads and at GQA's 8, and Llama-3-70B's 8192
   positions at rep 8), each attention kernel with the card time of its
   four kernels; the prologue of K2 and K3, ``actq_split``, alone, bit for
   bit; K2 and K3 timed as their C call, as actq_split alone and as the
   matmul alone on the workspace it filled (``split_ms``,
   ``matmul_alone_ms``), and, since the matmul starts as actq_split's
   programmatic dependent (PDL), 200 unsynchronised calls of each at
   qkv_proj's shape alternating two x on one workspace, every output its
   own x's bit for bit (``pdl_race``);
3. builds Llama-2-7B widths with random weights (seed 0), W6A6 block_fp
   (configs/quantization/bfp_6bit.toml), bf16 embedding / lm_head;
4. runs ``generate`` on sub-byte weights (pos-major cache: K1 + K4) and
   ``ContinuousBatcher`` on int8 weights (head-major cache: K2 with its
   ``actq_split`` + K5), each with every launch counter set to 0 just
   before it and read just after it (each run must launch its kernels and
   no other); then the
   batcher's tokens must equal reference ``generate`` rows for the same
   prompts;
5. holds one decode step's logits, kernel path against plain path (the
   plain path patches the wrappers here, in this script), and counts the
   launches of that step; on copies of the same cache, the step with
   ``attn_kernel=True`` (the same launches) and ``attn_kernel=False`` (the
   matmul kernels, no K4/K5, the dense route a layer), the latter's logits
   against the kernel route's, each a path of its own in the launch
   counts; times both routes, wall and card busy ms, at each format's
   serving layout (sub-byte at 256: K4, int8 at 512: K5); profiles decode
   steps of each format;
6. frees the Llama trees and builds OPT-6.7B widths (32 layers, random
   weights seed 0, W6A6 block_fp) twice: packed by ``init_opt_params``
   (transposed sub-byte words: K1) and with ``pack_common._to_t`` patched
   to the identity here (lane-major ``PackedBFPSub`` words: K3); runs OPT
   ``generate`` on each tree with the launch counters reset and read around
   it (K1 only, then K3 with its ``actq_split`` only; OPT decodes on a
   float32 cache, so no attention kernel), and holds a decode step of each
   tree against the plain path;
7. the perplexity path (``make_forward`` + ``eval_lm_wikitext2``, the
   paper's Wikitext2 protocol on the synthetic stream, random weights from
   seed 0) under nine arms, the perplexity sweep's seven and the two TOMLs
   it leaves out (``PPL_ARMS``): (1) each of the seven quantizers with its
   TOML's data_in and weight keys on the card and on the CPU, on a [2048,
   4096] activation with outlier channels, an [11008, 4096] weight and
   crafted blocks (zeros, +-5e-9, subnormals, every power of two and
   sqrt(2)*2^k and their neighbours, as block maxima and as elements):
   no bit may differ (NaN counts equal to NaN); (2) Llama-2-7B and
   OPT-6.7B widths at 1 layer, seq 64 (``PPL_CPU_LAYERS``, ``PPL_CPU_SEQ``): each arm's
   PTQ-prepared tree,
   prepared on the card, runs the forward on the card and on the CPU,
   with every quantizer, matmul, softmax, rsqrt and silu of the card's run
   shadowed on the CPU on the same inputs (``shadow_on_cpu``): no
   quantizer bit may differ, a float32 op within 1e-4 of its max; end to
   end |dloss| <= 1e-3 * loss and logits within 5e-2 of max|logit| for
   fp32, the quantized arms' gaps logged (a flipped rounding moves them by
   more); (3) Llama-2-7B
   widths, 16 layers (``PPL_LAYERS``; 32 before the parallel phase), seq 2048, batch 1,
   one sequence, weights quantized
   every call (the sweep's one-shot mode): loss, perplexity, seconds,
   tokens/s and peak memory of each arm, every loss finite, and the
   block_minifloat arm's PTQ flow (the CLI's) bit-equal to its one-shot
   loss; (4) the block_minifloat arm at seq 4096 with ``attention_chunk =
   512`` and without: losses within 1e-3 * loss, the chunked peak memory
   lower. The launch counters are set to 0 before the phase and must all
   read 0 after it: the path runs no Hopper kernel. Its results are the
   ``{"ppl": ...}`` line;
8. the QAT path (``train_qat``, ``eval_cls_glue``; the paper's Section 4.3
   protocol: W4A4 block_fp, batch 16, seq 128, lr 2e-5, cosine,
   grad-accum 4, random weights from seed 0, the synthetic classification
   stream): (1) one QAT step (forward with weights fake-quantized, STE
   backward) of OPT-350M and Llama-2-7B widths cut to 2 layers, batch 2 x
   64, on the card and on the CPU on the same weights: bypass's loss
   within 1e-5 relative and each leaf's gradient within 1e-4 of its
   max|grad|, bfp_4bit's loss within 2e-3 relative; (2) OPT-350M as
   published (24 layers, hidden 1024, word_embed_proj_dim 512, post-LN)
   with a 2-label head: 16 micro-steps (4 updates; 32 before phase 13)
   uninterrupted, timed (micro-step ms, samples/s, tokens/s, peak GB); the
   same run cut at micro-step 8 by a checkpoint and resumed, equal to it
   within rtol 1e-6 with the factory asked to seek to 8 once; 2 micro-steps timed,
   then 2 profiled, the second of them an update (card idle share,
   kernels by card time, GEMMs' share); a fixed batch's
   loss after 8 updates (its own lr 1e-6) below its first; eval_cls_glue
   on 128 samples (samples/s); (3) Llama-2-7B widths cut to 4 layers, a
   cls head, batch 16 x 128: a QAT step with ``remat`` and without, the
   same loss and gradients, the remat peak lower. The launch counters are
   set to 0 before the phase and must all read 0 after it. Its results are
   the ``{"qat": ...}`` line;
9. the probes (``llm_mixed_q_torch.tools``): holds every probe kernel
   (P8 and P9, the sub-byte matmul's knock-outs in K1's and K3's layouts,
   P1 and P3, its dequant-arithmetic and scale-storage variants in both
   layouts, P2, bf16 and float32 scales for the int8 matmul, and the
   tiling sweeps P4/P7 (``subbyte_tile``: K3's column tile and tiles a
   step) and P6/P5 (``int8_tile``: K2's column tile, K a step and K bands,
   with ``band_sum``), at the four Llama-2-7B projection shapes; P11,
   decode attention's knock-outs, at the probe's b = 32, S = 256) against
   its plain version; P12 and P13, more of decode attention's knock-outs
   and resident masks, at b = 32, S = 256 with every position filled and
   with pos = 100 (mid-block); P10, the scale expansion, at L = 8192,
   b = 32, its SASS showing that ``none`` keeps the scale loads), and each
   probe's copy of its production kernel
   against that kernel on bf16 x with no activation quantizer (transposed
   ship, v2 and v4 == K1; lane-major ship, v2, v4 and every
   ``subbyte_tile`` instance == ``subbyte_tile``'s c32_t1, the copy of K3's
   former CUDA-core design, and K3 on the tensor cores within 1e-5 of
   max|y| of it; P2 with either scale type and every
   ``int8_tile`` instance without bands == ``int8_tile``'s c32_k512, the
   copy of K2's CUDA-core design, and K2 on the tensor cores within 1e-5
   of max|y| of it; v3 and the band instance within 1e-5 of max|y|; P11's
   quant stage with float32 dots, the copy of K4's former design, is the
   anchor of the attention probes: P12's full, P13 and K4 are each within
   rtol 2e-4 / atol 2e-5 of it on quantized q; P13 == P12's full bit for
   bit on raw q), then drives the eight probe entry points (``ksub.run``,
   ``kvariants.run``, ``kvariants2.run``, ``aprobe.run``, ``kprobe.run``,
   ``ktune7b.run``, ``k3.run``, ``kexp.run``)
   with the launch counters set to 0 before each and read after it. The
   probe rows' ``ms`` come from those runs (``band_sum``'s from a call of
   its own); every serving path above launches no probe;
10. the serving tail and BERT (``--tail-only``): (1) at Llama-2-7B widths
   cut to 4 layers, ``make_prefill_and_decode`` (batch 8, prefill 32, 16
   decode steps on float k/v caches): float32 stitched logits against the
   full forward (rtol/atol 2e-4); W6A6 on sub-byte packed weights (K1, the
   launch counters around the run), against the plain path (within
   5e-2 of max|logit|: a float32 sum in another order flips a 6-bit
   rounding now and then) and the full forward (the gap logged: matmul_0
   quantizes k^T in blocks of positions that the full forward fills with
   later tokens), its ms a decode step; ``generate_greedy`` equal to
   ``generate`` at temperature 0; ``ContinuousBatcher.warmup`` on the
   batcher of run_llama's shape (int8 weights, head-major cache: K2 +
   ``actq_split`` + K5), its seconds and launches, the admissions' ms
   after it, every output equal to a batcher's without it;
   ``pack_llama_params_host`` against ``pack_llama_params`` on the card
   (1 layer, both formats): every packed leaf bit-equal, seconds a layer,
   the native engine's calls, the bytes moved; the incremental path card
   against CPU at 1 layer of Llama-2-7B and OPT-6.7B widths (float32
   within 1e-4 of max|logit|, W6A6 packed within 5e-2); (2) BERT-base as
   ``bert-base-uncased``'s config.json has it, random weights (seed 0), a
   2-label head, W4A4 ``bfp_4bit.toml``, batch 2 x 128: the PTQ
   forward card against CPU (bypass within 1e-4 of max|logit|, bfp_4bit
   within 0.66, the perplexity phase's largest quantized-arm gap); packed
   at 256 rows, sub-byte (K1) and int8 (K2 + ``actq_split``), each with the launch
   counters around it, against the plain path (5e-2) and the plain path
   against the fake-quant forward (rtol/atol 5e-4, the CPU test's), forward
   ms of each, a profiled K1 forward; K1 and K2 at BERT's three shapes and
   256 rows against their plain versions (1e-4 of max|y|) with their ms and
   bounds; ``eval_cls_glue`` (sst2) through ``cli_eval_cls_glue``'s
   ``build_model`` on the synthetic stream, 256 samples at batch 8, PTQ and
   packed (1024 rows a batch: the unpack + matmul route, no kernel); each
   of the eight heads once, finite. Its results are the ``{"tail": ...}``
   line;
11. statistic profiling (``--stats-only``): (1) Llama-2-7B, OPT-6.7B and
   BERT-base widths cut to 2 layers, random float weights (seed 0):
   ``profile_statistics(model_fn=...)`` with the CLI's defaults on the
   synthetic stream at 2 x 512, on the card and on the CPU from the same
   weights: the same keys in the same order (17 or 21 entries a layer),
   equal counts, min and max within 1e-4 of the entry's max|.|, variances
   within rtol 1e-3, means within 1e-3 of |mean| + the standard deviation;
   (2) Llama-2-7B widths at 32 layers: the paper's Section 1 protocol
   (4 batches of 4 x 2048 tokens, variance_online on the activations, no
   weight stats), then the CLI's defaults on one batch: seconds, tokens/s,
   peak GB, the variance against depth; 32 x 17 entries, every value
   finite; (3) that profile's 8-bit integer config (the transform, the
   Llama formatter and parser) through ``eval_lm_wikitext2`` at seq 2048,
   one sequence, beside float32: a finite loss, its perplexity and
   seconds; (4) the cost model: the memory density of W6A6 and W4A4 at
   7B widths, seq 2048, and one layer's ``param_bits`` / 8 beside its
   packed bytes (sub-byte and int8); parts 1-4 with the counters set to 0
   before them, all reading 0 after them; (5) the packed KV cache's route
   (fault 13), W6A6 int8 codes (K2), bf16 embedding, 2 layers:
   ``generate`` (batch 1, a 32-token prompt, 16 new tokens, max_len 8192)
   with the default cache, a ``PackedKVCache``, and with
   ``packed_kv=False``, at Meta-Llama-3-70B widths (past the JAX package's
   cap on its kernel's cache, within K5's limits: K5 runs 2 layers x 15
   steps) and at Mistral-Large-2 widths (rep 12, which both packages'
   kernels refuse: the dense route runs 2 layers x 15 steps, K4 and K5 0
   times): the same tokens, one decode step's logits within 5e-2 (K5) and
   1e-4 (dense) of max|logit|, each cache's bytes and ms a step; head_dims
   of 48 and 320, whose default packed cache decodes through K4 (2 layers
   x 3 steps), the dense route 0; and a head_dim of 6 (fault 18's repair:
   JAX's kernel takes it, and K4/K5 now too), whose default packed cache
   decodes through K4 at max_len 48 and through K5 at 4112 (2 layers x 3
   steps each), the dense route 0, its tokens the float32 cache's. Its
   results are the ``{"stats": ...}`` line;
12. search and prompting (``--search-only``): (1) faults 15's and 18's
   repairs: K4 and K5 against their plain versions (rtol 2e-4 / atol 2e-5;
   at head_dims 320, 40, 8, 6, 48 with blocks of 12 and 1280, bit for bit)
   at head_dims 48, 80, 96, 112, 320, 40 (blocks of 8), 8, 6 (blocks of
   6), 48 with blocks of 12 and 1280 (K5: P . V in passes of 1024 dims),
   rep 1 and 8, 8 kv heads, batch 8 (K4 at 1024 positions, K5 at 2048),
   and fault 21's caches (``F21_SHAPES``: K5 at 3012 dims, rep 8 and a
   scale a code, and at 5434 with one scale a head, its scores in passes;
   K4 at 65536 dims), each config's route "kernel", held with the prob
   quantizer off and logged with it on, each timed beside its plain
   version, its bound and SDPA; ``generate``
   of a Llama-family config at head_dim 80 (hidden 2560, 32 heads over 8
   kv heads, 2 layers, W6A6 int8 codes), batch 2,
   32 + 16 tokens, on its default packed cache at max_len 48 (K4) and 2048
   (K5), each run's counters showing its kernel launched and the dense
   route 0, every card token the CPU's argmax on the card's own history
   or within 1e-3 of max|logit| of it; (2) the classification search of
   ``configs/search/llama_7b_sst2.toml`` (TPE, seed 0, 6 trials) at
   Llama-2-7B widths cut to 4 layers, random weights, a 2-label head, 64 x
   128 synthetic tokens a trial: each trial's seconds, accuracy, memory
   density and average bitwidth, the peak GB, ``evaluate_best_trials``;
   the first 2 trials at 1 layer on 8 samples on the card and on the CPU:
   equal sampled configs and memory densities, and at most one prediction
   a trial apart, a near tie; (3) the conditional search, 3 trials, on a
   stat profile taken over 2 batches; (4) the prompting search, 3 trials,
   on 32 in-memory ``sst`` examples with a toy tokenizer, then the best
   trial's config (PTQ-prepared weights) on a 16-word greedy task through
   ``make_serving_generate_fn``, its counters showing K4 launched and the
   dense route 0, its greedy ids at 1 layer card against CPU as in (1).
   Parts 2-4 launch no kernel but the greedy eval's K4. Its results are
   the ``{"search": ...}`` line;
13. parallel/ (``--parallel-only``): two ranks (this script with
   ``--parallel-rank``) share the one card over gloo: (1) TP = 2 packed
   serving at Llama-2-7B widths cut to 2 layers on the sub-byte-T (K1) and
   int8 (K2 + actq_split) trees, ``generate`` at batch 8, 16 + 16 tokens,
   max_len 512 (each rank's 16 kv heads pos-major: K4) and 1024 (K5), its
   tokens equal to the one-process run of the same tree on the card and a
   decode step's logits within 5e-2 of max|logit| of it (bit-equal is
   reported), each rank's counters showing its kernels launched; (2) DP = 2
   and FSDP = 2 QAT at OPT-350M widths on global batches of 8 x 128, the
   same loss on both ranks: under W4A4, 2 micro-steps, the losses within
   rtol 1e-5 of one process on the ranks' slices, the parameters within lr
   an update and all but 1 in 10^3 elements within 1e-2 of their leaf's
   max change; in float32, 1 micro-step, the loss within rtol 1e-5 of one
   process on the ranks' slices and on the global batch, the gradient
   each leaf within 1e-4 of its max|grad| of the slices', the whole within
   1e-2 (L2) of the global batch's; beside it, in one process, the first
   forward of the global batch against its slices' (float32 logits within
   1e-5 of max|logit| at 24 layers, the W4A4 loss within 2e-3 at 2
   layers, and the W4A4 gap at 24 layers reported); (3) the five EMNLP
   drivers at --synthetic on the card, their artifacts there and finite;
   (4) ``graft_entry.dryrun_multichip(2)`` on the two ranks (one QAT step
   and a TP-sharded prefill and decode step on a float32 cache; finite
   loss and logits), no kernel launched. Two ranks share one card: its
   times are no scaling figures. Its results are the ``{"parallel": ...}``
   line;
14. the repo's root scripts on the port (``--scripts-only``): (a)
   ``graft_entry.entry()``'s fake-quant forward on the card against the
   same forward on the CPU, within 1e-4 of max|logit|; (b) the quality
   harness's (``llm_mixed_q_torch.quality``) Llama arm, trained 10 steps
   on the card, its perplexities finite and W6A6 packed within 1e-4
   (relative) of W6A6 fake-quant; (c) its 7B arm's teacher-forced
   per-layer parity at layers 0, 15 and 31 (7B-width layers drawn on the
   card, the oracle on the CPU), the packed layers through K2 and
   actq_split at 2 x 64 rows, a path of their own in the launch counts,
   packed against fake-quant on the card within 5e-2 of the reference RMS
   (a 6-bit rounding flipped by a sum in another order). (a) and (b)
   launch no kernel. Its results are the ``{"scripts": ...}`` line.

Any failed check raises (non-zero exit). The last line of stdout is the
device JSON; the kernel table is the JSON line before the ``nvidia-smi``
line, the root scripts' phase's the one before it, the parallel phase's
the one before that, the search phase's the one
before that, the statistics phase's the one before that, the serving-tail phase's the one before that, the QAT
phase's the one before that and the perplexity phase's the one before
that. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import math
import os
import subprocess
import sys
import time
from functools import partial
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
    """Launch counts of the serving kernels (with the layer calls of the
    packed cache's dense route, no kernel) and of the probes."""
    from llm_mixed_q_torch import kernels, tools

    return {**kernels.launch_counts(), **tools.launch_counts()}


def reset_all_launch_counts():
    """Every count of ``all_launch_counts`` to 0."""
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


def bound(nbytes, flops, peaks, bf16=False):
    """(ms, "bytes" or "operations"): the larger of the bytes over the memory
    rate and the operations over the peak for their operand type (float32
    CUDA cores, or bf16 tensor cores for bf16 operands)."""
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[2 if bf16 else 1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _split_and_matmul(kname, x, packed, actq):
    """K2's or K3's two kernels apart, on x: (actq_split alone into a
    workspace, the matmul alone on the workspace it filled: the C entry with
    split = 0, an ordinary launch), as callables."""
    from llm_mixed_q_torch.kernels import _cuda
    from llm_mixed_q_torch.kernels.dequant_matmul import _actq_args, _k_padded, actq_split_cuda

    k_pad = _k_padded(packed)
    hi, _, _ = actq_split_cuda(x, actq, k_pad)  # hi starts the workspace
    m, n, kw = x.shape[0], packed.out_features, hi.shape[1]
    y = torch.empty((m, n), device="cuda")
    entry, fmt = (("lmq_bfp_matmul_int8", ()) if kname.startswith("bfp_matmul_int8")
                  else ("lmq_bfp_matmul_subbyte", (packed.width,)))

    def matmul():
        rc = getattr(_cuda.lib(), entry)(
            x.data_ptr(), packed[0].data_ptr(), packed[1].data_ptr(), y.data_ptr(),
            hi.data_ptr(), m, n, packed.in_features, k_pad, kw, *fmt, packed.block_size,
            *_actq_args(actq), 0, _cuda.stream_ptr(x))
        _cuda.check(rc, entry)
        return y

    return (lambda: actq_split_cuda(x, actq, k_pad)), matmul


def _measure_matmul(kname, wrapper, packed, n, k, gen, peaks, flush, tensor_cores=False):
    """Hold one kernel against its plain version at decode rows (batch 8)
    and at the PREFILL_M rows of a prefill, with ACTQ and on raw float32 x;
    time it at batch 8, and a tensor-core kernel (K1, K2, K3) also at
    PREFILL_M rows (``prefill_*``). The operations bound is taken at the
    peak of the units the kernel runs on: the bf16 tensor cores. K2 and K3
    (actq_split, then the matmul with PDL, in one C call) are also timed
    apart at batch 8: actq_split alone (``split_ms``) and the matmul alone
    on the workspace it filled (``matmul_alone_ms``, its output the C
    call's bit for bit)."""
    from llm_mixed_q_torch.kernels.dequant_matmul import bfp_matmul_plain
    from llm_mixed_q_torch.kernels.packing import packed_nbytes, unpack
    from llm_mixed_q_torch.tools.timing import cuda_ms

    xs = {m: torch.randn((m, k), generator=gen, device="cuda") for m in (BATCH, PREFILL_M)}
    errs = {}
    for m, xm in xs.items():
        for actq in (ACTQ, None):
            y = wrapper(xm, packed, actq)
            ref = bfp_matmul_plain(xm, packed, actq)
            torch.cuda.synchronize()
            e = (y - ref).abs().max().item()
            rel = e / ref.abs().max().item()
            # tolerance of the JAX package's own kernel test: 1e-4 of max|y|
            # (float32 sums in another order; raw x as bf16 hi + lo on the
            # tensor cores)
            check(rel <= 1e-4, f"{kname} N={n} K={k} M={m} actq={actq}: rel err {rel}")
            if m not in errs or e > errs[m][0]:
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
    if kname.startswith(("bfp_matmul_int8", "bfp_matmul_subbyte ")):
        split, alone = _split_and_matmul(kname, xs[BATCH], packed, ACTQ)
        check(torch.equal(alone(), wrapper(xs[BATCH], packed, ACTQ)),
              f"{kname}: the matmul alone is not the C call's output")
        out["split_ms"] = cuda_ms(split, flush=flush)
        out["matmul_alone_ms"] = cuda_ms(alone, flush=flush)
        log(f"  {kname} N={n} K={k} M={BATCH}: the C call {out['ms']:.4f} ms = actq_split "
            f"alone {out['split_ms']:.4f} + the matmul alone {out['matmul_alone_ms']:.4f} - "
            f"{out['split_ms'] + out['matmul_alone_ms'] - out['ms']:.4f} of overlap")
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
    and at PREFILL_M rows; K1 and K3 also report the OPT-6.7B MLP shapes, on
    lines of their own (``opt_mlp_ms``, ``opt_mlp_prefill_ms``). ``only``:
    the one kernel to measure."""
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
        tensor_cores = kname in ("bfp_matmul_subbyte_t", "bfp_matmul_int8", "bfp_matmul_subbyte")
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


def c32_k512(x, packed, actq=None):
    """``int8_tile``'s c32_k512: the copy of K2's CUDA-core design (no
    activation quantizer), the anchor of P2's and the int8_tile probes'
    faithfulness and the former K2 of the M sweep."""
    from llm_mixed_q_torch.tools import ktune7b

    return ktune7b.int8_tile(x, packed, *ktune7b.INT8_INSTANCES["c32_k512"])


def c32_t1(x, packed, actq=None):
    """``subbyte_tile``'s c32_t1: the copy of K3's former CUDA-core design
    (no activation quantizer), the anchor of the lane-major probes'
    faithfulness and the former K3 of the M sweep."""
    from llm_mixed_q_torch.tools import kprobe

    return kprobe.subbyte_tile(x, packed, *kprobe.SUB_INSTANCES["c32_t1"])


def check_actq_split(peaks, flush):
    """The prologue of K2 and K3 alone at the K of each Llama-2-7B projection (its
    workspace padded as K2 pads it): equal to actq_split_plain bit for bit
    (hi, lo and the rows with a lo) at batch 8 and PREFILL_M rows, with ACTQ
    and on raw x; timed at batch 8, summed over the four projections. Its
    bound: x read, hi and lo written; operations, 6 float32 ones an
    element (|x|, block max, scaling, rounding, rescale, split). No single
    PyTorch call computes it (library_ms null). -> row."""
    from llm_mixed_q_torch.kernels.dequant_matmul import actq_split_cuda, actq_split_plain
    from llm_mixed_q_torch.models.pack_common import _k_stride
    from llm_mixed_q_torch.tools.timing import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    row = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_bytes_ms": 0.0,
           "bound_ops_ms": 0.0, "library_ms": None}
    for sname, (_, k) in MATMUL_SHAPES.items():
        stride = _k_stride(16, k) or 16
        k_pad = -(-k // stride) * stride
        for m in (BATCH, PREFILL_M):
            x = torch.randn((m, k), generator=gen, device="cuda")
            for actq in (ACTQ, None):
                got = actq_split_cuda(x, actq, k_pad)
                want = actq_split_plain(x, actq, got[0].shape[1])
                torch.cuda.synchronize()
                for g_, w_ in zip(got[:2], want[:2]):
                    check(torch.equal(g_.view(torch.int16), w_.view(torch.int16)),
                          f"actq_split {sname} M={m} actq={actq}: not its plain version")
                check(torch.equal(got[2], want[2]), f"actq_split {sname} M={m}: lo rows differ")
            if m != BATCH:
                continue
            kw = got[0].shape[1]
            row["ms"] += cuda_ms(lambda: actq_split_cuda(x, ACTQ, k_pad), flush=flush)
            row["plain_ms"] += cuda_ms(lambda: actq_split_plain(x, ACTQ, kw), reps=5, flush=flush)
            row["bound_bytes_ms"] += (4 * m * k + 4 * m * kw + m) / peaks[0] * 1e3
            row["bound_ops_ms"] += 6 * m * k / peaks[1] * 1e3
    log(f"  actq_split, four 7B projections' K at M={BATCH}: bit-exact; kernel_ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} bound_ms="
        f"{max(row['bound_bytes_ms'], row['bound_ops_ms']):.5f}")
    return row


PDL_CALLS = 200


def check_pdl_race():
    """K2 and K3 at qkv_proj's shape (N 12288, K 4096), batch 8: their
    matmul starts as actq_split's programmatic dependent and must wait for
    it before it reads the workspace. PDL_CALLS calls alternating x1 (raw
    float32: lo terms) and x2 (ACTQ-quantized: none) on ONE workspace, with
    no synchronisation between them: every output equal bit for bit to its
    own x's output from a synchronised call. -> {kernel: result}"""
    from llm_mixed_q_torch.kernels import dequant_matmul as dm
    from llm_mixed_q_torch.kernels.packing import pack_block_fp, pack_block_fp_subbyte
    from llm_mixed_q_torch.models.pack_common import _k_stride

    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    n, k = MATMUL_SHAPES["qkv_proj"]
    w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
    kernels = {"bfp_matmul_int8": (dm.bfp_matmul_cuda, pack_block_fp(
                   w, 6, 8, 127, [1, 16], k_stride=_k_stride(16, k))),
               "bfp_matmul_subbyte": (dm.bfp_matmul_subbyte_cuda,
                                      pack_block_fp_subbyte(w, 6, 8, 127, [1, 16]))}
    x1 = torch.randn((BATCH, k), generator=gen, device="cuda")
    x2 = dm._actq_qdq(torch.randn((BATCH, k), generator=gen, device="cuda") * 100, ACTQ)
    out = {}
    for kname, (fn, packed) in kernels.items():
        refs = [fn(x, packed) for x in (x1, x2)]
        torch.cuda.synchronize()
        one = dm._split_workspace(BATCH, dm._k_padded(packed), "cuda")
        with mock.patch.object(dm, "_split_workspace", lambda *_: one):
            ys = [fn((x1, x2)[i % 2], packed) for i in range(PDL_CALLS)]
        torch.cuda.synchronize()
        wrong = sum(not torch.equal(y, refs[i % 2]) for i, y in enumerate(ys))
        check(wrong == 0, f"{kname}: {wrong} of {PDL_CALLS} unsynchronised calls on one "
                          f"workspace differ from their own x's output")
        out[kname] = {"calls": PDL_CALLS, "differing": wrong}
        log(f"  {kname} qkv_proj, batch {BATCH}: {PDL_CALLS} calls alternating two x on one "
            f"workspace, unsynchronised: every output its own x's, bit for bit")
    del w, kernels
    torch.cuda.empty_cache()
    return out


SWEEP_M = (8, 16, 32, 64, 128, 256)


def m_sweep(flush):
    """K1, K2 and K3 with ACTQ at M in SWEEP_M, each beside unpack +
    torch.matmul of the same product (``bfp_matmul_plain``: the route
    bfp_matmul takes above _FUSED_M_MAX), int8_tile's c32_k512 (the copy of
    K2's CUDA-core design, no activation quantizer) beside K2 and
    subbyte_tile's c32_t1 (the same for K3) beside K3: ms summed over one
    Llama-2-7B layer's four projections. -> {row: {M: ms}}."""
    from llm_mixed_q_torch.kernels.dequant_matmul import (
        bfp_matmul_cuda, bfp_matmul_plain, bfp_matmul_subbyte_cuda, bfp_matmul_subbyte_t_cuda)
    from llm_mixed_q_torch.kernels.packing import (
        pack_block_fp, pack_block_fp_subbyte, pack_block_fp_subbyte_t)
    from llm_mixed_q_torch.models.pack_common import _k_stride
    from llm_mixed_q_torch.tools.timing import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    kernels = {
        "K1": (bfp_matmul_subbyte_t_cuda, pack_block_fp_subbyte_t),
        "K2": (bfp_matmul_cuda, lambda w, *a: pack_block_fp(w, *a, k_stride=_k_stride(16, w.shape[1]))),
        "K3": (bfp_matmul_subbyte_cuda, pack_block_fp_subbyte),
    }
    out = {}
    for sname, (n, k) in MATMUL_SHAPES.items():
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        for kname, (wrapper, packer) in kernels.items():
            packed = packer(w, 6, 8, 127, [1, 16])
            for m in SWEEP_M:
                x = torch.randn((m, k), generator=gen, device="cuda")
                calls = {kname: lambda: wrapper(x, packed, ACTQ),
                         f"{kname} unpack+matmul": lambda: bfp_matmul_plain(x, packed, ACTQ)}
                if kname == "K2":
                    calls["c32_k512 (no actq)"] = lambda: c32_k512(x, packed)
                if kname == "K3":
                    calls["c32_t1 (no actq)"] = lambda: c32_t1(x, packed)
                for label, call in calls.items():
                    out.setdefault(label, {}).setdefault(m, 0.0)
                    out[label][m] += cuda_ms(call, reps=10, flush=flush)
            del packed
        del w
    for label, by_m in out.items():
        log(f"  M sweep {label}: " + ", ".join(f"M={m} {t:.4f}" for m, t in by_m.items()))
    return out


def _cache_inputs(gen, s_len, nkv, hd, pos_major, bs=16):
    """A filled packed cache of random K/V in blocks of ``bs``, as serving
    lays it out."""
    from llm_mixed_q_torch.kernels.packing import bfp_encode_lastdim

    k = torch.randn((BATCH, nkv, s_len, hd), generator=gen, device="cuda")
    v = torch.randn((BATCH, nkv, s_len, hd), generator=gen, device="cuda")
    kc, ks = bfp_encode_lastdim(k, 6, 8, 127, bs)
    vc, vs = bfp_encode_lastdim(v, 6, 8, 127, bs)
    if pos_major:
        flat = lambda t: t.permute(0, 3, 2, 1).reshape(BATCH, t.shape[3], s_len * nkv).contiguous()
        return flat(kc), flat(ks), flat(vc), flat(vs)
    return (kc.transpose(2, 3).contiguous(), ks.transpose(2, 3).contiguous(),
            vc.contiguous(), vs.contiguous())


# K4's shapes: name -> (nkv, rep, max_len, positions of the batch). "full":
# Llama-2-7B, the cache nearly full (the kernel table's shape); "generate":
# the same at position 31, where chip_smoke's generate runs; "gqa": GQA at
# the pos-major layout's 8192-lane cap (8 kv heads, rep 4, 1024 positions);
# "rep8_8192": rep 8 on one kv head at that cap (8192 positions)
K4_SHAPES = {
    "full": (HEADS, 1, 256, [255 - 9 * i for i in range(BATCH)]),
    "generate": (HEADS, 1, 256, [31] * BATCH),
    "gqa": (8, 4, 1024, [1023 - 9 * i for i in range(BATCH)]),
    "rep8_8192": (1, 8, 8192, [8191 - 997 * i for i in range(BATCH)]),
}

# K5's shapes: name -> (nkv, rep, max_len, positions of the batch). "full":
# Llama-2-7B at the batcher's max_len 512, the cache nearly full (the
# kernel table's shape); "batcher": the same where chip_smoke's batcher
# decodes (prompts of 5-32 tokens and 32 new ones); "long": Llama-2-7B at
# the JAX package's head-major cap (4096 positions of head_dim 128); "gqa":
# Llama-3-8B / Mistral-7B attention widths (8 kv heads, rep 4) at 4096
# positions, past the pos-major layout's 1024; "rep8_8192": Llama-3-70B's
# (8 kv heads, rep 8) at its 8192 positions, past the JAX package's cap
K5_SHAPES = {
    "full": (HEADS, 1, 512, [511 - 9 * i for i in range(BATCH)]),
    "batcher": (HEADS, 1, 512, [63 - 8 * i for i in range(BATCH)]),
    "long": (HEADS, 1, 4096, [4095 - 9 * i for i in range(BATCH)]),
    "gqa": (8, 4, 4096, [4095 - 9 * i for i in range(BATCH)]),
    "rep8_8192": (8, 8, 8192, [8191 - 997 * i for i in range(BATCH)]),
}


def _attention_row(kname, run, plain, sdpa, positions, nkv, rep, hd, peaks, flush, bs=16):
    """Hold ``run`` against ``plain`` (rtol 2e-4 / atol 2e-5, the JAX
    package's kernel test) and time it, the plain version and ``sdpa``;
    bound: the filled positions' cache bytes (codes and scales of K and V,
    blocks of ``bs``), q and ctx, and 4 * hd flops a position and query row
    at the float32 peak."""
    from llm_mixed_q_torch.tools.timing import cuda_ms

    out, ref = run(), plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    check(torch.isfinite(out).all().item(), f"{kname}: non-finite ctx")
    check(torch.allclose(out, ref, rtol=2e-4, atol=2e-5), f"{kname}: max err {err}")
    filled = int((positions.long() + 1).sum().item())  # positions read
    per_pos = nkv * (2 * hd + 2 * (hd // bs) * 4)  # K+V codes and scales
    nbytes = filled * per_pos + 4 * out.numel() * 2 + 4 * positions.numel()
    b_ms, b_by = bound(nbytes, filled * nkv * rep * 4 * hd, peaks)
    return dict(ms=cuda_ms(run, flush=flush), plain_ms=cuda_ms(plain, reps=5, flush=flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(sdpa, flush=flush),
                max_abs_err=err)


def kernel_times(fn, calls=20):
    """Card time of ``fn`` by kernel name (torch.profiler), ms a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    name = lambda key: key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
    return {name(e.key): e.self_device_time_total / calls / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


ROUTE_CALLS = 3  # decode steps a route is timed over
# the cache length of each Llama format's serving run: generate's pos-major
# cache (K4), the batcher's head-major one (K5)
SERVING_MAX_LEN = {"sub-byte": 256, "int8": 512}


def route_times(steps, calls=ROUTE_CALLS):
    """{name: (wall ms, card busy ms)} of a call of each of ``steps``
    {name: fn}: the median over ``calls`` calls on the host clock, the
    routes taken in turn so that a drift of the shared host falls on each
    alike, and the sum of ``kernel_times`` over ``calls`` calls."""
    walls = {name: [] for name in steps}
    for step in steps.values():
        step()
    for _ in range(calls):
        for name, step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    return {name: (float(np.median(walls[name])), sum(kernel_times(step, calls).values()))
            for name, step in steps.items()}


def _k5_geometry_sweep(call, nkv, rep, s_len, flush):
    """K5's time at other geometries, (P, T) -> ms: chunks of 64 to 1024
    positions a block, tiles of 64 or 128 positions a ring stage, with the
    wrapper's ``k5_geometry`` patched (the kernel takes any powers of two
    T <= P), and ``k5_geometry``'s own choice."""
    from llm_mixed_q_torch.kernels import attention_decode as ad
    from llm_mixed_q_torch.tools.timing import cuda_ms

    out = {}
    for p in (64, 128, 256, 512, 1024):
        for t in (64, 128):
            if t <= p <= s_len:
                with mock.patch.object(ad, "k5_geometry", lambda *_, g=(p, t): g):
                    out[f"{p}x{t}"] = cuda_ms(call, flush=flush)
    out["chosen"] = "x".join(map(str, ad.k5_geometry(nkv, rep, s_len)))
    return out


def check_attention_kernels(peaks, flush, only=None, sweep=False):
    """K4 at the three K4_SHAPES and K5 at the four K5_SHAPES (each row's
    numbers: "full"; the others under "shapes"), batch 8, q quantized as
    serving quantizes it, prob quantizer [1, 16] W6: each against its plain
    version, timed beside its plain version, its bound and SDPA on a
    dequantized float32 cache masked to the filled positions (no prob
    quantization; GQA through ``enable_gqa``), with the card time of each
    of its kernels. ``only``: the one wrapper name to run; ``sweep``: K5
    also at other chunk and tile lengths. -> rows."""
    from llm_mixed_q_torch.kernels.attention_decode import (
        packed_attention_decode_batch_cuda, packed_attention_decode_batch_plain,
        packed_attention_decode_cuda, packed_attention_decode_plain)
    from llm_mixed_q_torch.ops.quantizers import _block_fp_qdq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    hd = HIDDEN // HEADS
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def inputs(nkv, rep, s_len, positions, pos_major):
        positions = torch.tensor(positions, dtype=torch.int32, device="cuda")
        cache = _cache_inputs(gen, s_len, nkv, hd, pos_major)
        q = _block_fp_qdq(torch.randn((BATCH * nkv * rep, hd), generator=gen, device="cuda"),
                          6, 8, 127, [1, 16], True)
        kd = torch.randn((BATCH, nkv, s_len, hd), generator=gen, device="cuda")
        vd = torch.randn_like(kd)
        mask = (torch.arange(s_len, device="cuda")[None, None, None, :]
                <= positions.long()[:, None, None, None])
        library = lambda: sdpa(q.reshape(BATCH, nkv * rep, 1, hd), kd, vd, attn_mask=mask,
                               enable_gqa=rep > 1)
        return positions, cache, q, library

    kernels = {  # wrapper name: shapes, pos-major cache, kernel, plain version
        "attn_decode_pos_major": (K4_SHAPES, True, packed_attention_decode_batch_cuda,
                                  packed_attention_decode_batch_plain),
        "attn_decode_head_major": (K5_SHAPES, False, packed_attention_decode_cuda,
                                   packed_attention_decode_plain),
    }
    rows = {}
    for kname, (shapes, pos_major, fn, plain) in kernels.items():
        if only not in (None, kname):
            continue
        for name, (nkv, rep, s_len, pos_list) in shapes.items():
            positions, cache, q, library = inputs(nkv, rep, s_len, pos_list, pos_major)
            if pos_major:
                args = (q.reshape(BATCH, nkv * rep, hd), *cache, positions, 16, 16, nkv, rep,
                        PROB_Q)
            else:
                args = (q.reshape(BATCH, nkv, rep, hd), *cache, positions, 16, 16, PROB_Q)
            r = _attention_row(f"{kname} {name}", lambda: fn(*args), lambda: plain(*args),
                               library, positions, nkv, rep, hd, peaks, flush)
            log(f"  {kname} {name} (nkv {nkv}, rep {rep}, max_len {s_len}, positions "
                f"{pos_list[0]}..{pos_list[-1]}): max_abs_err={r['max_abs_err']:.3e} "
                f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"library_ms(SDPA on a dequantized f32 cache)={r['library_ms']:.4f}")
            # where the time goes: the call's kernels, back to back
            r["kernels_ms"] = kernel_times(lambda: fn(*args))
            log(f"    by kernel (torch.profiler, no flush): {r['kernels_ms']}")
            if sweep and not pos_major:
                r["geometries_ms"] = _k5_geometry_sweep(lambda: fn(*args), nkv, rep, s_len,
                                                        flush)
                log(f"    by (P, T) (ms, L2 flushed): {r['geometries_ms']}")
            if name == "full":
                rows[kname] = dict(r, shapes={})
            else:
                rows[kname]["shapes"][name] = r
                rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"], r["max_abs_err"])
            del positions, cache, q, library, args
            torch.cuda.empty_cache()  # the long caches take ~2-4 GB with their yardstick
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
    """Wall time of a decode step, or of any call (host clock, no
    profiler), and the card's busy time in it by kernel (torch.profiler, a
    second window of steps); ``step(i)`` runs the i-th step.
    -> {"wall_ms", "busy_ms", "idle_share", "gemm_ms", "launches"}"""
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
    # (a user annotation, such as the optimizer's step, also has a device
    # range, over kernels that are counted on their own)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    gemm_ms = sum(e.self_device_time_total for e in kernels
                  if "gemm" in e.key.lower()) / steps / 1e3
    launches = sum(e.count for e in kernels) / steps
    log(f"profile ({label}, {steps} steps): "
        f"wall {wall_ms:.2f} ms a step, card busy {busy_ms:.2f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f}), GEMMs {gemm_ms:.2f} ms; "
        f"{len(kernels)} kernel names, {launches:.0f} launches a step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / steps / 1e3:8.3f} ms a step, "
            f"{e.count / steps:6.1f} launches: {e.key[:90]}")
    # kernels in a top-level anonymous namespace: every csrc/ kernel (and a
    # few of PyTorch's, such as its arange)
    ours = [e for e in kernels if e.key.replace("void ", "").startswith("(anonymous namespace)::")]
    log("  kernels in an anonymous namespace (the port's, a few of PyTorch's): " + "; ".join(
        f"{e.key.replace('void ', '').replace('(anonymous namespace)::', '').split('(')[0]} "
        f"{e.self_device_time_total / steps / 1e3:.3f} ms ({e.count / steps:.0f})"
        for e in sorted(ours, key=lambda e: -e.self_device_time_total)))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "gemm_ms": gemm_ms, "launches": launches}


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


def _decode_route_paths():
    """run_llama's decode steps with the attention route forced, at batch 8
    on the packed cache of max_len 256 (pos-major) and 512 (head-major):
    attn_kernel=True takes K4 / K5, False the dense route on the packed
    codes (no attention kernel)."""
    paths = {}
    for fmt, matmul in (("subbyte", ("bfp_matmul_subbyte_t",)),
                        ("int8", ("bfp_matmul_int8", "actq_split"))):
        for n, attention in ((256, "attn_decode_pos_major"), (512, "attn_decode_head_major")):
            paths[f"decode_{fmt}_{n}_attn_kernel"] = matmul + (attention,)
            paths[f"decode_{fmt}_{n}_dense"] = matmul + ("attn_decode_packed_dense",)
    return paths


# the kernels each main path must launch (and no other), by path
PATHS = {
    "generate": ("bfp_matmul_subbyte_t", "attn_decode_pos_major"),
    "ContinuousBatcher": ("bfp_matmul_int8", "actq_split", "attn_decode_head_major"),
    **_decode_route_paths(),
    "opt_generate_t": ("bfp_matmul_subbyte_t",),
    "opt_generate_lane_major": ("bfp_matmul_subbyte", "actq_split"),
    "ppl": (),  # the perplexity phase: fake quantization, no Hopper kernel
    "qat": (),  # the QAT phase: fake quantization and its backward, no Hopper kernel
    # phase 10: make_prefill_and_decode on sub-byte weights (float k/v caches:
    # no attention kernel), the batcher's warmup (int8 weights, head-major
    # cache), BERT-base packed at 256 rows both ways, and its GLUE eval at
    # 1024 rows a batch (the unpack + matmul route)
    "prefill_and_decode": ("bfp_matmul_subbyte_t",),
    "warmup": ("bfp_matmul_int8", "actq_split", "attn_decode_head_major"),
    "bert_packed_t": ("bfp_matmul_subbyte_t",),
    "bert_packed_int8": ("bfp_matmul_int8", "actq_split"),
    "bert_eval": (),
    # phase 11: statistic profiling, the integer config's eval and the cost
    # model (the float forward and fake quantization: no Hopper kernel); fault
    # 13's generate on int8 weights at Llama-3-70B widths, its default packed
    # cache through K5, and at Mistral-Large-2 widths, through the dense route
    # (no attention kernel), each also on the float32 cache
    "stats": (),
    "fault13_packed": ("bfp_matmul_int8", "actq_split", "attn_decode_head_major"),
    "fault13_float32": ("bfp_matmul_int8", "actq_split"),
    "fault13_dense_packed": ("bfp_matmul_int8", "actq_split", "attn_decode_packed_dense"),
    "fault13_dense_float32": ("bfp_matmul_int8", "actq_split"),
    # phase 12: generate at head_dim 80 (fault 15) on int8 weights, its packed
    # cache through K4 (max_len 48) and K5 (max_len 2048)
    "head_dim_80_pos_major": ("bfp_matmul_int8", "actq_split", "attn_decode_pos_major"),
    "head_dim_80_head_major": ("bfp_matmul_int8", "actq_split", "attn_decode_head_major"),
    # the searches' trials and evals (the fake-quant forward: no Hopper
    # kernel), and the prompting eval's serving generate_fn on the best
    # trial's config (float weights fake-quantized, its packed cache: K4)
    "search_cls": (), "search_conditional": (), "search_prompting": (),
    "prompting_generate": ("attn_decode_pos_major",),
}
PROBE_REPS = 1  # timed chains a variant in the probe entry points
# the probe entry points: each probe kernel and the production kernels
# they print beside it
PROBE_PATHS = {
    "ksub": ("probe_subbyte_t", "probe_subbyte", "bfp_matmul_subbyte_t", "bfp_matmul_subbyte",
             "actq_split"),
    "kvariants": ("probe_matmul_variant_t", "probe_matmul_variant", "bfp_matmul_subbyte_t",
                  "bfp_matmul_subbyte", "actq_split"),
    "kvariants2": ("probe_sub_variant_t", "probe_sub_variant", "probe_int8_variant",
                   "bfp_matmul_subbyte_t", "bfp_matmul_subbyte", "bfp_matmul_int8", "actq_split"),
    "aprobe": ("probe_attention", "attn_decode_pos_major"),
    "kprobe": ("probe_subbyte_tile", "bfp_matmul_subbyte", "bfp_matmul_int8", "actq_split"),
    "ktune7b": ("probe_int8_tile", "probe_band_sum", "probe_subbyte_tile", "bfp_matmul_int8",
                "actq_split", "bfp_matmul_subbyte"),
    "k3": ("probe_attention_v2", "probe_attention_v3", "attn_decode_pos_major"),
    "kexp": ("probe_expand",),
}
_VARIANT_CU = "llm_mixed_q_torch/csrc/probes/variant_probe.cu"
_INT8_TILE_CU = "llm_mixed_q_torch/csrc/probes/int8_tile_probe.cu"
_ATTENTION_CU = "llm_mixed_q_torch/csrc/probes/attention_probe.cu"
PROBE_SOURCES = {  # name: (source, the TPU probe's pallas_call)
    "probe_subbyte_t": ("llm_mixed_q_torch/csrc/probes/subbyte_probe.cu", "tools/ksub.py:225"),
    "probe_subbyte": ("llm_mixed_q_torch/csrc/probes/subbyte_probe.cu", "tools/ksub.py:270"),
    "probe_matmul_variant_t": (_VARIANT_CU, "tools/kvariants.py:130"),
    "probe_matmul_variant": (_VARIANT_CU, "tools/kvariants.py:130"),
    "probe_sub_variant_t": (_VARIANT_CU, "tools/kvariants2.py:170"),
    "probe_sub_variant": (_VARIANT_CU, "tools/kvariants2.py:170"),
    "probe_int8_variant": ("llm_mixed_q_torch/csrc/probes/int8_probe.cu", "tools/kvariants2.py:90"),
    "probe_attention": (_ATTENTION_CU, "tools/aprobe.py:122"),
    "probe_attention_v2": (_ATTENTION_CU, "tools/k3.py:156"),
    "probe_attention_v3": (_ATTENTION_CU, "tools/k3.py:221"),
    "probe_expand": ("llm_mixed_q_torch/csrc/probes/expand_probe.cu", "tools/kexp.py:103"),
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
               "probe_subbyte_tile": "c32_t1", "probe_int8_tile": "c32_k512",
               "probe_attention_v2": "full", "probe_attention_v3": "v3_masks",
               "probe_expand": "index"}


def check_path_counts(path_counts):
    for path, counts in path_counts.items():
        log(f"launches of the {path} run: {counts}")
        for kname, c in counts.items():
            if kname in {**PATHS, **PROBE_PATHS}[path]:
                check(c > 0, f"kernel {kname} was not launched by the {path} run")
            else:
                check(c == 0, f"kernel {kname} was launched by the {path} run")


def run_llama(smi):
    """Llama-2-7B widths: generate (K1 + K4), ContinuousBatcher (K2 with
    actq_split + K5), decode steps against the plain path and with the
    attention route forced both ways (``attn_kernel``), timed, and a
    profiled step. -> launch counts by path. The trees are freed on
    return."""
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

    # one decode step, kernel path against plain path, on the same cache;
    # the route forced by attn_kernel (True: K4/K5, False: the dense route on
    # the packed codes) on copies of the cache as it was before the step
    fields = ("k_codes", "k_scales", "v_codes", "v_scales")
    route_ms = {}
    t_loop = time.perf_counter()
    for label, params in (("sub-byte", sub), ("int8", int8)):
        for max_len in (256, 512):
            spec = kv_cache_pack_spec(config)
            ids = torch.as_tensor(g_ids, device="cuda")
            mask = torch.as_tensor(g_mask, device="cuda")
            cache = init_packed_kv_cache(config, BATCH, max_len, spec, "cuda")
            logits, lengths = prefill_into_cache(params, ids, mask, cache, config)
            tok = torch.argmax(logits, -1)[:, None]
            snapshot = [[t.clone() for t in f] for f in cache[:4]]
            fresh = lambda: cache._replace(**dict(zip(fields, [[t.clone() for t in f]
                                                               for f in snapshot])))
            reset_all_launch_counts()
            got = decode_step(params, tok, cache, lengths, config)
            step_counts = all_launch_counts()
            route = f"decode_{label.replace('-', '')}_{max_len}"
            reset_all_launch_counts()
            forced = decode_step(params, tok, fresh(), lengths, config, attn_kernel=True)
            path_counts[f"{route}_attn_kernel"] = all_launch_counts()
            check(path_counts[f"{route}_attn_kernel"] == step_counts,
                  f"attn_kernel=True launched {path_counts[f'{route}_attn_kernel']}, "
                  f"the default route {step_counts}")
            reset_all_launch_counts()
            dense = decode_step(params, tok, fresh(), lengths, config, attn_kernel=False)
            path_counts[f"{route}_dense"] = all_launch_counts()
            check(path_counts[f"{route}_dense"]["attn_decode_packed_dense"] == LAYERS,
                  f"attn_kernel=False: {path_counts[f'{route}_dense']}")
            check_path_counts({k: path_counts[k] for k in (f"{route}_attn_kernel",
                                                            f"{route}_dense")})
            with plain_path():
                want = decode_step(params, tok, fresh(), lengths, config)
            check(all_launch_counts() == path_counts[f"{route}_dense"],
                  "the plain path launched a kernel")
            log(f"launches in one decode step ({label}, max_len {max_len}): "
                f"{ {k: c for k, c in step_counts.items() if c} }; attn_kernel=False: "
                f"{ {k: c for k, c in path_counts[f'{route}_dense'].items() if c} }")
            rel = ((got - want).abs().max() / want.abs().max()).item()
            rel_dense = ((dense - got).abs().max() / got.abs().max()).item()
            agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
            log(f"decode step logits, kernel vs plain ({label}, max_len {max_len}): "
                f"max err {rel:.3e} of max|logit|, argmax agreement {agree:.3f}; dense route "
                f"vs kernel route {rel_dense:.3e}; attn_kernel=True vs default "
                f"{(forced - got).abs().max().item():.3e}")
            # ulp-level differences of float32 sums flip a 5-bit rounding of
            # the re-quantized activations now and then; over 32 layers that
            # moves the logits by a few percent of their range at most
            check(rel <= 5e-2, f"decode logits differ: {rel}")
            check(rel_dense <= 5e-2, f"dense-route decode logits differ: {rel_dense}")
            if max_len == SERVING_MAX_LEN[label]:  # the layout of the format's serving run
                route_ms[label] = route_times({
                    name: partial(decode_step, params, tok, cache, lengths, config,
                                  attn_kernel=attn_kernel)
                    for name, attn_kernel in (("kernel", True), ("dense", False))})
    log(f"the decode steps' checks and the routes' times took "
        f"{time.perf_counter() - t_loop:.1f} s")
    for label, (kernel, dense) in ((k, (v["kernel"], v["dense"])) for k, v in route_ms.items()):
        n = SERVING_MAX_LEN[label]
        log(f"decode step ({label}, batch {BATCH}, {LAYERS} layers, max_len {n}: "
            f"{'K4' if n == 256 else 'K5'}), wall / card busy ms, median of {ROUTE_CALLS} calls "
            f"a route ({smi}): kernel route {kernel[0]:.3f} / {kernel[1]:.3f}, dense route "
            f"{dense[0]:.3f} / {dense[1]:.3f}")

    check(not mismatched, f"batcher requests {mismatched} != generate rows")

    # profiled steps of each format, on the cache layout of its serving run
    for label, params, max_len in (("sub-byte", sub, 256), ("int8", int8, 512)):
        cache = init_packed_kv_cache(config, BATCH, max_len, kv_cache_pack_spec(config), "cuda")
        logits, lengths = prefill_into_cache(params, torch.as_tensor(g_ids, device="cuda"),
                                             torch.as_tensor(g_mask, device="cuda"), cache, config)
        tok = torch.argmax(logits, -1)[:, None]
        profile_decode(f"Llama {label}, batch {BATCH}, max_len {max_len}",
                       lambda i: decode_step(params, tok, cache, lengths + i, config))
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


# the perplexity phase (7): the arms of experiments/emnlp/section_4_2_perplexity.py
# and the two TOMLs it leaves out; block_fp.toml's 8-bit arm is covered by
# the two bfp ones. arm -> TOML stem (bypass: no quant config, as the
# sweep's fp32 arm)
PPL_ARMS = {"fp32": "bypass", "w8a8_int": "integer", "w6a6_bfp": "bfp_6bit",
            "w4a4_bfp": "bfp_4bit", "block_minifloat": "block_minifloat",
            "block_log": "block_log", "minifloat_ieee": "minifloat_ieee",
            "minifloat_denorm": "minifloat_denorm", "log": "log"}
# each arithmetic with the TOML whose data_in and weight keys it runs
PPL_QUANTIZERS = {"integer": "integer", "block_fp": "bfp_6bit",
                  "minifloat_denorm": "minifloat_denorm", "minifloat_ieee": "minifloat_ieee",
                  "log": "log", "block_minifloat": "block_minifloat", "block_log": "block_log"}
# the paper's protocol: seq_len 2048, batch 1; one sequence an arm keeps the
# whole run near its former length (part 2's CPU forwards take most of it)
PPL_SEQ, PPL_SEQS = 2048, 1
PPL_LONG, PPL_CHUNK = 4096, 512  # Llama-2's context, chunked attention
# parts 3 and 4's depth: cut from 32 layers to 16 for the parallel phase
# (13); the arms' seconds, tokens/s and peaks are those of 16 layers
PPL_LAYERS = 16
# part 2's depth and length against the CPU: cut from 2 layers at seq 512
# to 1 layer at seq 128 to leave the script's time limit room for the
# search phase (12), then to seq 64 for fault 18's shapes and the PDL
# checks; its CPU forwards and shadows go with the tokens
PPL_CPU_LAYERS, PPL_CPU_SEQ = 1, 64


def _toml(stem):
    return str(ROOT / f"configs/quantization/{stem}.toml")


def _ppl_config(family, layers, stem, **kw):
    from llm_mixed_q_torch.models import get_config_cls

    quant = None if stem == "bypass" else _toml(stem)
    if family == "llama":
        return get_config_cls("llama")(
            vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=INTER,
            num_hidden_layers=layers, num_attention_heads=HEADS,
            max_position_embeddings=PPL_LONG, quant_config=quant, **kw)
    return get_config_cls("opt")(
        vocab_size=OPT_VOCAB, hidden_size=OPT_HIDDEN, ffn_dim=OPT_FFN, num_hidden_layers=layers,
        num_attention_heads=OPT_HEADS, max_position_embeddings=2048,
        word_embed_proj_dim=OPT_HIDDEN, do_layer_norm_before=True, activation_function="relu",
        enable_bias=True, quant_config=quant)


def _crafted_blocks(rng):
    """[N, 16] float32: every power of two and sqrt(2)*2^k, and their 3
    nearest float32 on each side, as the maximum of a block whose other
    elements are random fractions of it; the same points as elements;
    zeros, +-5e-9 and subnormals; random signs."""
    f32 = np.float32
    p = np.ldexp(f32(1), np.arange(-149, 128)).astype(f32)
    s = (np.sqrt(2.0) * np.ldexp(1.0, np.arange(-149, 127))).astype(f32)
    pts = [p, s]
    for a in (p, s):
        lo, hi = a, a
        for _ in range(3):
            lo, hi = np.nextafter(lo, f32(0)), np.nextafter(hi, f32(np.inf))
            pts += [lo, hi]
    pts = np.concatenate(pts)
    pts = pts[(pts > 0) & np.isfinite(pts)]
    fractions = np.concatenate([np.ones((len(pts), 1)), rng.uniform(0, 1, (len(pts), 15))], 1)
    special = np.array([0.0, 5e-9, -5e-9, 1e-40, -3e-39, 2.0 ** -149, 2.0 ** -127, 1e-45], f32)
    elems = np.concatenate([pts, special])
    elems = np.concatenate([elems, np.zeros((-len(elems)) % 16, f32)]).reshape(-1, 16)
    rows = np.concatenate([(pts[:, None] * fractions).astype(f32), elems])
    return torch.from_numpy((rows * rng.choice([-1, 1], rows.shape)).astype(f32))


def _differing_bits(a, b):
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
    return int((~same).sum())


def ppl_arithmetic():
    """Part 1: each quantizer on the card and on the CPU, bit for bit; its
    card time on the weight. -> {arith: {entry:tensor: differing, ...}}"""
    from llm_mixed_q_torch.ops.functions import make_entry_quantizer
    from llm_mixed_q_torch.utils import load_config

    gen = torch.Generator().manual_seed(SEED)
    act = torch.randn(2048, HIDDEN, generator=gen) * 0.3
    act[:, torch.randperm(HIDDEN, generator=gen)[:8]] *= 30  # outlier channels
    weight = torch.randn(INTER, HIDDEN, generator=gen) * 0.02
    crafted = _crafted_blocks(np.random.default_rng(SEED))
    rows = {}
    for arith, stem in PPL_QUANTIZERS.items():
        cfg = load_config(_toml(stem))["default"]
        row = {}
        for entry, skip, tensors in (("data_in", True, {"act": act, "crafted": crafted}),
                                     ("weight", False, {"weight": weight, "crafted": crafted})):
            q = make_entry_quantizer(cfg, entry, skip_first_dim=skip)
            for name, t in tensors.items():
                row[f"{entry}:{name}"] = _differing_bits(q(t.cuda()).cpu(), q(t))
        w = weight.cuda()
        q = make_entry_quantizer(cfg, "weight", skip_first_dim=False)
        q(w)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            q(w)
        end.record()
        torch.cuda.synchronize()
        row["weight_ms"] = start.elapsed_time(end) / 5
        log(f"  {arith} ({stem}.toml): differing bits card vs CPU "
            f"{ {k: v for k, v in row.items() if k != 'weight_ms'} }; "
            f"[{INTER}, {HIDDEN}] weight quantized in {row['weight_ms']:.3f} ms on the card")
        check(not any(v for k, v in row.items() if k != "weight_ms"),
              f"{arith}: card and CPU differ: {row}")
        rows[arith] = row
    return rows


def _eval(fwd, params, ds):
    """eval_lm_wikitext2 on the stream; -> (results, logits of the first
    batch on the CPU, wall seconds, peak device GB)."""
    from llm_mixed_q_torch.datasets import numpy_dataloader
    from llm_mixed_q_torch.eval import eval_lm_wikitext2

    kept = []

    def keep(*a):
        out = fwd(*a)
        if not kept:
            kept.append(out["logits"].cpu())
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = eval_lm_wikitext2(keep, params, numpy_dataloader(ds, batch_size=1))
    torch.cuda.synchronize()
    return res, kept[0], time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


@contextlib.contextmanager
def shadow_on_cpu(report):
    """Run every quantizer, matmul, softmax, rsqrt and silu that is called
    on card tensors once more on the CPU, on copies of the same inputs, and
    keep in ``report[name]`` [calls, calls that differ, worst]: the most
    differing bits of a quantizer call, max|card - cpu| / max|cpu| of a
    float32 op's."""
    from llm_mixed_q_torch.ops import functions, linear

    def cpu(a):
        if isinstance(a, torch.Tensor):
            return a.cpu()
        if isinstance(a, (list, tuple)):
            return type(a)(cpu(x) for x in a)
        return a

    def shadow(name, f, exact=False):
        def run(*a, **k):
            out = f(*a, **k)
            if any(isinstance(x, torch.Tensor) and x.is_cuda for x in a):
                want = f(*cpu(a), **k)
                got = out.cpu()
                if exact:
                    err = _differing_bits(got, want)
                else:
                    err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
                r = report.setdefault(name, [0, 0, 0.0])
                r[0], r[1], r[2] = r[0] + 1, r[1] + (err > 0), max(r[2], err)
            return out
        return run

    make_q = functions.make_entry_quantizer

    def entry_quantizer(config, entry, skip_first_dim=False):
        return shadow(f"{config['name']} {entry}", make_q(config, entry, skip_first_dim),
                      exact=True)

    with mock.patch.object(functions, "make_entry_quantizer", entry_quantizer), \
            mock.patch.object(linear, "make_entry_quantizer", entry_quantizer), \
            mock.patch.object(torch, "matmul", shadow("matmul", torch.matmul)), \
            mock.patch.object(torch, "softmax", shadow("softmax", torch.softmax)), \
            mock.patch.object(torch, "rsqrt", shadow("rsqrt", torch.rsqrt)), \
            mock.patch.object(torch.nn.functional, "silu", shadow("silu", torch.nn.functional.silu)):
        yield


def ppl_card_vs_cpu():
    """Part 2: PPL_CPU_LAYERS layers of Llama-2-7B and OPT-6.7B widths, seq
    PPL_CPU_SEQ: each
    arm's tree PTQ-prepared on the card, its bits copied to the CPU, the
    PTQ forward on both. On the card every quantizer and float32 op is
    shadowed on the CPU (``shadow_on_cpu``): on the same inputs no
    quantizer bit may differ, and a float32 op's output is within 1e-4 of
    its max (sums in another order). The forward amplifies those float32
    differences once a rounding flips (a 3-bit mantissa moves by 1/8 of
    its block), so end to end the gates |dloss| <= 1e-3 * loss
    and logits within 5e-2 of max|logit| hold the fp32 arm, and the
    quantized arms' gaps are logged. -> {family: {arm: gaps}}"""
    from llm_mixed_q_torch.datasets import make_synthetic_lm_dataset
    from llm_mixed_q_torch.models import get_ptq_preparer
    from llm_mixed_q_torch.models.api import make_forward
    from llm_mixed_q_torch.models.hf_loader import (init_llama_params, init_opt_params,
                                                    tree_map_tensors)

    out = {}
    for family, init in (("llama", init_llama_params), ("opt", init_opt_params)):
        base = _ppl_config(family, PPL_CPU_LAYERS, "bypass")
        card_params = init(base, seed=SEED)
        ds = make_synthetic_lm_dataset(base.vocab_size, PPL_CPU_SEQ, 1, seed=SEED)
        rows = {}
        for arm, stem in PPL_ARMS.items():
            config = _ppl_config(family, PPL_CPU_LAYERS, stem)
            card_tree = get_ptq_preparer(family)(card_params, config)
            cpu_tree = tree_map_tensors(lambda t: t.cpu(), card_tree)
            fwd = make_forward(family, "lm", config, quantize_weights=False, with_labels=True)
            ops = {}
            with shadow_on_cpu(ops):
                res, logits, _, _ = _eval(fwd, card_tree, ds)
            want, want_logits, _, _ = _eval(fwd, cpu_tree, ds)
            row = {"loss_card": res["loss"], "loss_cpu": want["loss"],
                   "loss_gap_rel": abs(res["loss"] - want["loss"]) / want["loss"],
                   "logits_err_of_max": ((logits - want_logits).abs().max()
                                         / want_logits.abs().max()).item(),
                   "ops": ops}
            rows[arm] = row
            log(f"  {family} {PPL_CPU_LAYERS} layer(s), {arm}: loss card {res['loss']:.6f} cpu {want['loss']:.6f} "
                f"(gap {row['loss_gap_rel']:.3e} of loss), logits gap "
                f"{row['logits_err_of_max']:.3e} of max|logit|; ops on the card's inputs, "
                f"[calls, differing, worst]: {ops}")
            for name, (_, _, worst) in ops.items():
                if name in ("matmul", "softmax", "rsqrt", "silu"):
                    check(worst <= 1e-4, f"{family} {arm}: {name} on the card is {worst:.3e} "
                                         f"of its max from the CPU's")
                else:
                    check(worst == 0, f"{family} {arm}: quantizer {name} differs on the card "
                                      f"in {worst} elements")
            if stem == "bypass":
                check(row["loss_gap_rel"] <= 1e-3,
                      f"{family} {arm}: card and CPU losses differ by {row['loss_gap_rel']:.3e}")
                check(row["logits_err_of_max"] <= 5e-2,
                      f"{family} {arm}: card and CPU logits differ by {row['logits_err_of_max']:.3e}")
            del card_tree, cpu_tree
        out[family] = rows
        del card_params
        torch.cuda.empty_cache()
    return out


def ppl_sweep():
    """Parts 3 and 4: the sweep at full depth, then the chunked pair.
    -> ({arm: row}, {"unchunked": row, "chunked": row})"""
    from llm_mixed_q_torch.datasets import make_synthetic_lm_dataset
    from llm_mixed_q_torch.models import get_ptq_preparer
    from llm_mixed_q_torch.models.api import make_forward
    from llm_mixed_q_torch.models.hf_loader import init_llama_params

    t0 = time.perf_counter()
    params = init_llama_params(_ppl_config("llama", PPL_LAYERS, "bypass"), seed=SEED)
    torch.cuda.synchronize()
    log(f"  Llama-2-7B widths, {PPL_LAYERS} layers, float32 weights (seed {SEED}): "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, made in {time.perf_counter() - t0:.1f} s")
    ds = make_synthetic_lm_dataset(VOCAB, PPL_SEQ, PPL_SEQS, seed=SEED)
    sweep = {}
    for arm, stem in PPL_ARMS.items():
        config = _ppl_config("llama", PPL_LAYERS, stem)
        fwd = make_forward("llama", "lm", config, quantize_weights=True, with_labels=True)
        res, _, secs, peak = _eval(fwd, params, ds)
        row = {"loss": res["loss"], "perplexity": res["perplexity"], "seconds": secs,
               "tokens_per_s": PPL_SEQ * PPL_SEQS / secs, "peak_gb": peak}
        check(math.isfinite(res["loss"]), f"{arm}: loss {res['loss']}")
        if arm == "block_minifloat":
            # the CLI's flow: weights quantized once, then quantize_weights=False
            prepared = get_ptq_preparer("llama")(params, config)
            ptq, _, ptq_secs, ptq_peak = _eval(
                make_forward("llama", "lm", config, quantize_weights=False, with_labels=True),
                prepared, ds)
            del prepared
            torch.cuda.empty_cache()
            row.update(ptq_loss=ptq["loss"], ptq_seconds=ptq_secs, ptq_peak_gb=ptq_peak)
            check(ptq["loss"] == res["loss"],
                  f"PTQ loss {ptq['loss']!r} != one-shot loss {res['loss']!r}")
            # where a one-shot forward's card time goes, and how long the card waits
            batch = [torch.as_tensor(ds[k][:1]).cuda()
                     for k in ("input_ids", "attention_mask", "labels")]
            with torch.inference_mode():
                row["profile"] = profile_decode(
                    f"a one-shot perplexity forward, {arm}, seq {PPL_SEQ}",
                    lambda i: fwd(params, *batch), steps=1)
        log(f"  {arm}: " + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                                     for k, v in row.items()))
        sweep[arm] = row

    long_ds = make_synthetic_lm_dataset(VOCAB, PPL_LONG, 1, seed=SEED)
    chunked = {}
    for name, chunk in (("unchunked", None), ("chunked", PPL_CHUNK)):
        config = _ppl_config("llama", PPL_LAYERS, "block_minifloat", attention_chunk=chunk)
        res, _, secs, peak = _eval(make_forward("llama", "lm", config, with_labels=True),
                                   params, long_ds)
        chunked[name] = {"loss": res["loss"], "seconds": secs, "peak_gb": peak,
                         "tokens_per_s": PPL_LONG / secs}
        log(f"  block_minifloat at seq {PPL_LONG}, {name}: loss {res['loss']:.6f}, "
            f"{secs:.2f} s, peak {peak:.2f} GB")
    gap = abs(chunked["chunked"]["loss"] - chunked["unchunked"]["loss"]) / chunked["unchunked"]["loss"]
    chunked["loss_gap_rel"] = gap
    check(gap <= 1e-3, f"chunked and unchunked losses differ by {gap:.3e}")
    check(chunked["chunked"]["peak_gb"] < chunked["unchunked"]["peak_gb"],
          "chunked attention did not lower the peak memory")
    del params
    torch.cuda.empty_cache()
    return sweep, chunked


def run_ppl():
    """Phase 7, the perplexity path, with every launch counter set to 0
    before it and read after it. -> ({"ppl": results}, launch counts)"""
    t0 = time.perf_counter()
    reset_all_launch_counts()
    log("phase 7, part 1: quantizers card vs CPU (differing bits; must be 0):")
    arith = ppl_arithmetic()
    t1 = time.perf_counter()
    log(f"part 1 took {t1 - t0:.1f} s; phase 7, part 2: {PPL_CPU_LAYERS}-layer forwards "
        f"card vs CPU "
        f"(PTQ trees prepared on the card):")
    gaps = ppl_card_vs_cpu()
    t2 = time.perf_counter()
    log(f"part 2 took {t2 - t1:.1f} s; phase 7, parts 3 and 4: the sweep at {PPL_LAYERS} layers, "
        f"seq {PPL_SEQ} x {PPL_SEQS}, then seq {PPL_LONG} with and without chunked attention:")
    sweep, chunked = ppl_sweep()
    log(f"parts 3 and 4 took {time.perf_counter() - t2:.1f} s")
    counts = all_launch_counts()
    check_path_counts({"ppl": counts})
    secs = time.perf_counter() - t0
    log(f"phase 7 (perplexity path) took {secs:.1f} s")
    return {"ppl": {"seconds": secs, "arithmetic": arith, "card_vs_cpu": gaps,
                    "sweep": sweep, "chunked": chunked}}, counts

# the QAT phase (8): the paper's Section 4.3 protocol
# (experiments/emnlp/section_4_3_qat.py): W4A4 block_fp, batch 16, seq 128,
# lr 2e-5, cosine, grad-accum 4, on OPT-350M as published in
# facebook/opt-350m's config.json (post-LN, word_embed_proj_dim 512 != hidden)
OPT350 = dict(vocab_size=50272, hidden_size=1024, ffn_dim=4096, num_hidden_layers=24,
              num_attention_heads=16, max_position_embeddings=2048, word_embed_proj_dim=512,
              do_layer_norm_before=False, activation_function="relu", pad_token_id=1,
              num_labels=2)
QAT_BATCH, QAT_SEQ, QAT_LR, QAT_ACCUM = 16, 128, 2e-5, 4
# micro-steps (4 updates), checkpoint, eval samples: cut from 32, 16, 256 to
# leave the script's time limit room for the parallel phase (13)
QAT_MICRO, QAT_SAVE_AT, QAT_EVAL = 16, 8, 128
# the fixed-batch check's own lr: on random weights Adam's first steps at 2e-5
# (every parameter moved by ~lr) overshoot, the loss rising to 2-3 nats
QAT_FALL_LR = 1e-6
QAT_CHECK_BATCH, QAT_CHECK_SEQ = 2, 64  # part 1: the CPU side takes seconds
QAT_LLAMA_LAYERS = 4  # part 3


def _qat_config(family, layers, stem):
    from llm_mixed_q_torch.models import get_config_cls

    quant = None if stem == "bypass" else _toml(stem)
    if family == "opt":
        return get_config_cls("opt")(**{**OPT350, "num_hidden_layers": layers},
                                     quant_config=quant)
    return get_config_cls("llama")(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=INTER, num_hidden_layers=layers,
        num_attention_heads=HEADS, max_position_embeddings=PPL_LONG, num_labels=2,
        quant_config=quant)


def _qat_grads(family, config, params, batch, remat=None):
    """One QAT forward (weights fake-quantized) and backward on a trainable
    copy of ``params``, on their device; ``remat`` (Llama) runs the
    backbone with and without recomputation. -> (loss, {path: grad} of
    the leaves the step reaches)"""
    from llm_mixed_q_torch.models import get_model_fn
    from llm_mixed_q_torch.models.llama.modeling import llama_model, sequence_classification_head
    from llm_mixed_q_torch.train.qat import _trainable, named_leaves

    device = next(t for _, t in named_leaves(params)).device
    tp = _trainable(params)
    ids, mask, labels = (torch.as_tensor(batch[k], device=device)
                         for k in ("input_ids", "attention_mask", "labels"))
    if remat is None:
        loss = get_model_fn(family, "cls")(tp, ids, mask, labels=labels, config=config,
                                           quantize_weights=True)["loss"]
    else:
        hidden, _ = llama_model(tp, ids, mask, config, quantize_weights=True, remat=remat)
        loss = sequence_classification_head(tp, hidden, ids, labels, config)["loss"]
    loss.backward()
    # (a post-LN OPT's top-level final_layer_norm is unused: no gradient)
    return loss.item(), {"/".join(map(str, p)): t.grad for p, t in named_leaves(tp)
                         if t.grad is not None}


def _grad_gaps(got, want):
    """Each leaf's max|got - want| over its max|want|. An attention key's
    bias has a gradient of 0 in exact arithmetic (the softmax ignores a
    shift shared by every key), so each side holds only its own rounding
    noise there: those leaves are held below 1e-5 of the largest leaf's
    max on both sides instead. -> (worst gap, its leaf, {key-bias leaf:
    (card, CPU) max|grad| over the largest leaf's})"""
    top = max(g.abs().max().item() for g in want.values())
    worst, at, noise = 0.0, None, {}
    for k, w in want.items():
        g = got[k].cpu()
        if k.endswith("k_proj/bias"):
            noise[k] = (g.abs().max().item() / top, w.abs().max().item() / top)
            check(max(noise[k]) < 1e-5, f"gradient of {k} is not rounding noise: {noise[k]}")
            continue
        gap = (g - w).abs().max().item() / w.abs().max().item()
        if gap > worst:
            worst, at = gap, k
    return worst, at, noise


def qat_card_vs_cpu():
    """Part 1: one QAT step's loss and gradients, card against CPU, on the
    same weights and batch, at OPT-350M and Llama-2-7B widths cut to 2
    layers. bypass: loss within 1e-5 relative, each leaf's gradient within
    1e-4 of its max|grad|; bfp_4bit: loss within 2e-3 relative (a float32
    sum in another order flips a 3-bit rounding now and then; the
    quantizers themselves are bit-equal, part 1 of phase 7), its gradient
    gaps logged. -> {family: {arm: gaps}}"""
    from llm_mixed_q_torch.datasets import make_synthetic_cls_dataset
    from llm_mixed_q_torch.models.hf_loader import (init_llama_params, init_opt_params,
                                                    tree_map_tensors)

    out = {}
    for family, init in (("opt", init_opt_params), ("llama", init_llama_params)):
        base = _qat_config(family, 2, "bypass")
        card_params = init(base, task="cls", seed=SEED)
        cpu_params = tree_map_tensors(lambda t: t.cpu(), card_params)
        batch = make_synthetic_cls_dataset(base.vocab_size, QAT_CHECK_SEQ, QAT_CHECK_BATCH,
                                           seed=SEED)
        rows = {}
        for stem, loss_tol in (("bypass", 1e-5), ("bfp_4bit", 2e-3)):
            config = _qat_config(family, 2, stem)
            t0 = time.perf_counter()
            loss, grads = _qat_grads(family, config, card_params, batch)
            t1 = time.perf_counter()
            want_loss, want = _qat_grads(family, config, cpu_params, batch)
            gap = abs(loss - want_loss) / want_loss
            worst, at, noise = _grad_gaps(grads, want)
            rows[stem] = {"loss_card": loss, "loss_cpu": want_loss, "loss_gap_rel": gap,
                          "grad_gap_of_leaf_max": worst, "worst_leaf": at,
                          "key_bias_noise": noise, "card_s": t1 - t0,
                          "cpu_s": time.perf_counter() - t1}
            log(f"  {family} 2 layers, {stem}: loss card {loss:.7f} cpu {want_loss:.7f} "
                f"(gap {gap:.3e} of loss), worst gradient gap {worst:.3e} of its leaf's max "
                f"({at}); key biases (noise, of the largest leaf's max) {noise}; card {t1 - t0:.2f} s, "
                f"CPU {rows[stem]['cpu_s']:.2f} s")
            check(gap <= loss_tol, f"{family} {stem}: card and CPU losses differ by {gap:.3e}")
            if stem == "bypass":
                check(worst <= 1e-4, f"{family} bypass: gradient {at} differs by {worst:.3e}")
            del grads, want
        out[family] = rows
        del card_params, cpu_params
        torch.cuda.empty_cache()
    return out


def _leaf_gap(a, b):
    """The largest elementwise |a - b| / |b| over the leaves of two trees
    (the rtol that would hold them)."""
    from llm_mixed_q_torch.train.qat import named_leaves

    ref = dict(named_leaves(b))
    return max(((t - ref[p]).abs() / ref[p].abs().clamp_min(1e-30)).max().item()
               for p, t in named_leaves(a))


def qat_protocol():
    """Part 2: the Section 4.3 protocol at OPT-350M's full widths and depth
    through ``train_qat``: ``QAT_MICRO`` micro-steps uninterrupted; the same
    run cut at micro-step ``QAT_SAVE_AT`` (a checkpoint) and resumed, which
    must equal it (rtol 1e-6); a profiled window of micro-steps; a fixed
    batch's loss over 8 updates, which must fall; ``eval_cls_glue`` on
    ``QAT_EVAL`` samples."""
    import tempfile

    from llm_mixed_q_torch.datasets import make_synthetic_cls_dataset, numpy_dataloader
    from llm_mixed_q_torch.eval import eval_cls_glue
    from llm_mixed_q_torch.models.api import make_forward
    from llm_mixed_q_torch.models.hf_loader import init_opt_params
    from llm_mixed_q_torch.train import train_qat
    from llm_mixed_q_torch.train.qat import (MultiSteps, _trainable, make_adamw,
                                             make_qat_train_step, named_leaves)

    config = _qat_config("opt", OPT350["num_hidden_layers"], "bfp_4bit")
    t0 = time.perf_counter()
    params = init_opt_params(config, task="cls", seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in named_leaves(params))
    log(f"  OPT-350M, {n_params / 1e6:.1f} M parameters (seed {SEED}), made in "
        f"{time.perf_counter() - t0:.1f} s")
    ds = make_synthetic_cls_dataset(OPT350["vocab_size"], QAT_SEQ, QAT_BATCH * QAT_MICRO,
                                    seed=SEED)
    batches = list(numpy_dataloader(ds, QAT_BATCH))
    calls = []

    def factory(start=0):
        calls.append(start)
        yield from batches[start:]

    common = dict(num_epochs=1, learning_rate=QAT_LR, grad_accum_steps=QAT_ACCUM,
                  schedule="cosine", steps_per_epoch=QAT_MICRO, log_every=QAT_MICRO)
    res = {"parameters": n_params}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        full, hist = train_qat("opt", "cls", config, params, factory,
                               metrics_path=f"{tmp}/full.jsonl", **common)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        losses = [json.loads(l)["loss"] for l in open(f"{tmp}/full.jsonl") if '"step"' in l]
        res.update(seconds=secs, micro_step_ms=secs / QAT_MICRO * 1e3,
                   samples_per_s=QAT_BATCH * QAT_MICRO / secs,
                   tokens_per_s=QAT_BATCH * QAT_SEQ * QAT_MICRO / secs,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9, losses=losses,
                   epoch_loss=hist[0]["loss"])
        log(f"  {QAT_MICRO} micro-steps ({QAT_MICRO // QAT_ACCUM} updates): {secs:.2f} s, "
            f"{res['micro_step_ms']:.1f} ms a micro-step, {res['samples_per_s']:.1f} samples/s, "
            f"{res['tokens_per_s']:.0f} tokens/s, peak {res['peak_gb']:.2f} GB; losses "
            f"{[round(l, 4) for l in losses]}")
        check(len(losses) == QAT_MICRO and all(math.isfinite(l) for l in losses),
              f"QAT losses: {losses}")

        t0 = time.perf_counter()
        train_qat("opt", "cls", config, params, lambda start=0: itertools.islice(
            factory(start), QAT_SAVE_AT - start), checkpoint_dir=f"{tmp}/ckpt",
                  save_every_steps=QAT_SAVE_AT, **common)
        t1 = time.perf_counter()
        calls.clear()
        resumed, _ = train_qat("opt", "cls", config, params, factory,
                               checkpoint_dir=f"{tmp}/ckpt", resume=True, **common)
        torch.cuda.synchronize()
        gap = _leaf_gap(resumed, full)
        res.update(resume_gap_rtol=gap, resume_calls=list(calls),
                   cut_run_s=t1 - t0, resumed_run_s=time.perf_counter() - t1)
        log(f"  cut at {QAT_SAVE_AT} and resumed (factory asked for {calls}): largest "
            f"elementwise relative gap to the uninterrupted run {gap:.3e}; cut run "
            f"{t1 - t0:.1f} s with its checkpoint, resumed run {res['resumed_run_s']:.1f} s")
        check(calls == [QAT_SAVE_AT], f"resume asked the factory for {calls}")
        check(gap <= 1e-6, f"the resumed run differs from the uninterrupted one by {gap:.3e}")
        del resumed

    # micro-steps 1-2 timed, then 3-4 profiled (the 4th updates)
    tp = _trainable(params)
    opt = MultiSteps(*make_adamw(tp, QAT_LR, 0.0, QAT_MICRO, 0, "cosine"), every_k=QAT_ACCUM)
    step = make_qat_train_step("opt", "cls", config, opt)
    dev = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()} for b in batches[:4]]
    res["profile"] = profile_decode(
        f"QAT micro-steps, OPT-350M, batch {QAT_BATCH} x {QAT_SEQ}, W4A4 block_fp",
        lambda i: step(tp, dev[i]), steps=2)
    del tp, opt, step

    # a fixed batch's loss falls over 8 updates: the 9th micro-step's loss
    # is read after the 8th update
    with tempfile.TemporaryDirectory() as tmp:
        train_qat("opt", "cls", config, params, lambda: iter([batches[0]] * 9),
                  learning_rate=QAT_FALL_LR, metrics_path=f"{tmp}/fixed.jsonl", log_every=100)
        fixed = [json.loads(l)["loss"] for l in open(f"{tmp}/fixed.jsonl") if '"step"' in l]
    res["fixed_batch_losses"] = fixed
    log(f"  a fixed batch, 8 updates at lr {QAT_FALL_LR}: losses {[round(l, 4) for l in fixed]}")
    check(len(fixed) == 9 and fixed[-1] < fixed[0],
          f"the fixed batch's loss did not fall: {fixed}")

    eval_ds = make_synthetic_cls_dataset(OPT350["vocab_size"], QAT_SEQ, QAT_EVAL, seed=SEED + 1)
    fwd = make_forward("opt", "cls", config, quantize_weights=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = eval_cls_glue(fwd, full, "sst2", numpy_dataloader(eval_ds, QAT_BATCH),
                            num_samples=QAT_EVAL)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    res["eval"] = {**metrics, "seconds": secs, "samples_per_s": QAT_EVAL / secs}
    log(f"  eval_cls_glue (sst2 metrics) on {QAT_EVAL} samples: {metrics}, {secs:.2f} s, "
        f"{QAT_EVAL / secs:.1f} samples/s")
    check(0.0 <= metrics["accuracy"] <= 1.0, f"eval metrics {metrics}")
    del full, params
    torch.cuda.empty_cache()
    return res


def qat_remat():
    """Part 3: Llama-2-7B widths cut to 4 layers, a cls head, W4A4 block_fp,
    batch 16 x 128: one QAT step with ``remat`` and one without. The same
    loss and gradients (within 1e-6 relative and 1e-5 of each leaf's max;
    the same kernels on the same inputs, expected equal), and the remat
    peak lower. -> {"plain": row, "remat": row, gaps}"""
    from llm_mixed_q_torch.datasets import make_synthetic_cls_dataset
    from llm_mixed_q_torch.models.hf_loader import init_llama_params

    config = _qat_config("llama", QAT_LLAMA_LAYERS, "bfp_4bit")
    params = init_llama_params(config, task="cls", seed=SEED)
    batch = make_synthetic_cls_dataset(VOCAB, QAT_SEQ, QAT_BATCH, seed=SEED)
    rows, grads = {}, {}
    for name, remat in (("plain", False), ("remat", True)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads[name] = _qat_grads("llama", config, params, batch, remat=remat)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        rows[name] = {"loss": loss, "seconds": time.perf_counter() - t0, "peak_gb": peak / 1e9,
                      "peak_over_weights_gb": (peak - base) / 1e9}
        log(f"  Llama-2-7B widths, {QAT_LLAMA_LAYERS} layers, {name}: loss {loss:.7f}, "
            f"{rows[name]['seconds']:.2f} s, peak {peak / 1e9:.2f} GB "
            f"({(peak - base) / 1e9:.2f} GB over the {base / 1e9:.2f} GB resident)")
        if name == "plain":
            grads[name] = {k: g.cpu() for k, g in grads[name].items()}
    loss_gap = abs(rows["remat"]["loss"] - rows["plain"]["loss"]) / rows["plain"]["loss"]
    grad_gap = max(((grads["remat"][k].cpu() - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                   for k, g in grads["plain"].items())
    rows.update(loss_gap_rel=loss_gap, grad_gap_of_leaf_max=grad_gap)
    log(f"  remat against plain: loss gap {loss_gap:.3e}, largest gradient gap {grad_gap:.3e} "
        f"of its leaf's max")
    check(loss_gap <= 1e-6 and grad_gap <= 1e-5,
          f"remat changes the step: loss {loss_gap:.3e}, gradients {grad_gap:.3e}")
    check(rows["remat"]["peak_gb"] < rows["plain"]["peak_gb"], "remat did not lower the peak")
    del params, grads
    torch.cuda.empty_cache()
    return rows


def run_qat():
    """Phase 8, the QAT path, with every launch counter set to 0 before it
    and read after it. -> ({"qat": results}, launch counts)"""
    t0 = time.perf_counter()
    reset_all_launch_counts()
    log("phase 8, part 1: a QAT step card vs CPU at 2 layers (batch "
        f"{QAT_CHECK_BATCH} x {QAT_CHECK_SEQ}):")
    gaps = qat_card_vs_cpu()
    t1 = time.perf_counter()
    log(f"part 1 took {t1 - t0:.1f} s; phase 8, part 2: the Section 4.3 protocol on OPT-350M "
        f"(batch {QAT_BATCH} x {QAT_SEQ}, lr {QAT_LR}, cosine, grad-accum {QAT_ACCUM}):")
    protocol = qat_protocol()
    t2 = time.perf_counter()
    log(f"part 2 took {t2 - t1:.1f} s; phase 8, part 3: remat at Llama-2-7B widths:")
    remat = qat_remat()
    log(f"part 3 took {time.perf_counter() - t2:.1f} s")
    counts = all_launch_counts()
    check_path_counts({"qat": counts})
    secs = time.perf_counter() - t0
    log(f"phase 8 (QAT path) took {secs:.1f} s")
    return {"qat": {"seconds": secs, "card_vs_cpu": gaps, "protocol": protocol,
                    "remat": remat}}, counts


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
    activation quantizer (its lo term is then 0: the same product; in the
    lane-major layout ship equals c32_t1, the copy of K3's former design
    that it copies, bit for bit, and K3 is within 1e-5 of max|y| of it),
    timed beside it and beside the production kernel with ACTQ. -> {probe:
    row}, sums over the four shapes."""
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
            ship = ksub.subbyte_probe(x_bf, packed, "ship")
            if pname == "K3":
                anchor = c32_t1(x_bf, packed)
                torch.cuda.synchronize()
                check(torch.equal(ship, anchor), f"{name} ship vs c32_t1 {sname}: not bit for bit")
                err = _close_to_max(prod(x_bf, packed, None), anchor, 1e-5,
                                    f"K3 vs c32_t1 {sname}")
                log(f"  {name} {sname}: ship == c32_t1 bit for bit, K3 within 1e-5 of it")
            else:
                err = _close_to_max(ship, prod(x_bf, packed, None), 1e-4,
                                    f"{name} ship vs {pname} {sname}")
            times = {"ship": cuda_ms(lambda: ksub.subbyte_probe(x_bf, packed, "ship"), flush=flush),
                     pname: cuda_ms(lambda: prod(x_bf, packed, None), flush=flush),
                     f"{pname} actq": cuda_ms(lambda: prod(xk, packed, ACTQ), flush=flush)}
            for key, t in times.items():
                _add(row["beside_ms"], key, t)
            log(f"  {name} {sname} N={n} K={k}: ship vs {pname} without actq on bf16 x "
                f"(max abs err {err:.3e}); ms " + ", ".join(f"{key} {t:.4f}" for key, t in times.items()))
    return rows


def check_attention_probe(peaks, flush):
    """P11 at the TPU probe's shape (b = 32, S = 256, nh = nkv = 32, hd = 128,
    every position filled, inputs from seed 0, q quantized as the serving
    path quantizes it, so the scores are exact in float32 whatever the order
    of their sums, as in K4's check): every stage and dot type against its
    plain version (dma, dequant: bit-exact; matmul: 1e-4 of max|ctx| with
    float32 dots, 1e-3 with bf16 dots; softmax, quant: rtol 2e-4 / atol
    2e-5), its plain time and bound (bf16 dots at the bf16 tensor-core
    peak); SDPA on a dequantized float32 cache as the yardstick of the
    softmax and quant stages (as K4's); then K4 against the quant stage with
    float32 dots, the anchor of the attention probes (a copy of K4's former
    design, one block a (batch element, kv head)), timed beside it. -> row."""
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
            b_ms, b_by = bound(nbytes, flops, peaks, bf16=dot == "bf16")
            row["variants"][label] = dict(max_abs_err=err, plain_ms=cuda_ms(plain, reps=3, flush=flush),
                                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
            log(f"  probe_attention {label}: max_abs_err={err:.3e} bound_ms={b_ms:.4f} ({b_by}) "
                f"plain_ms={row['variants'][label]['plain_ms']:.4f}")
    kd = torch.randn((b, nkv, s_len, hd), device="cuda")
    vd = torch.randn_like(kd)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q.reshape(b, nkv, 1, hd), kd, vd), flush=flush)
    for stage in ("softmax", "quant"):
        for dot in aprobe.DOTS[stage]:
            row["variants"][f"{stage}/{dot}"]["library_ms"] = library_ms
    k4 = lambda: packed_attention_decode_batch_cuda(
        q, kc, ks, vc, vs, pos, aprobe.BSK, aprobe.BSV, nkv=nkv, rep=aprobe.REP,
        prob_q=aprobe.PROB_Q)
    got, anchor = k4(), aprobe.attention_probe(*inputs, "quant")
    err = (got - anchor).abs().max().item()
    check(torch.allclose(got, anchor, rtol=2e-4, atol=2e-5), f"K4 vs quant/f32: max err {err}")
    row["k4_vs_anchor_err"] = err
    row["beside_ms"] = {"quant/f32": cuda_ms(lambda: aprobe.attention_probe(*inputs, "quant"),
                                             flush=flush), "K4": cuda_ms(k4, flush=flush)}
    log(f"  K4 within rtol 2e-4 / atol 2e-5 of the anchor quant/f32 (max abs err {err:.3e}); ms "
        + ", ".join(f"{key} {t:.4f}" for key, t in row["beside_ms"].items()))
    return row


def check_k3_probes(peaks, flush):
    """P12 (every stage) and P13 at the TPU probe's shape (b = 32, S = 256,
    nh = nkv = 32, hd = 128, inputs from seed 0), at pos = 255 (every
    position filled) and pos = 100 (mid-block: qmax's block reaches 111),
    q quantized as the serving path quantizes it (bf16-exact, so the
    scores are exact in float32 whatever the order of their sums): each
    against its plain version (dots: 1e-3 of max|ctx|; the others rtol
    2e-4 / atol 2e-5), its plain time and bound at pos = 255; SDPA on a
    dequantized float32 cache as the yardstick of softmax, full and masks (as
    K4's); then faithfulness, on quantized q: full, masks and K4 are each
    within rtol 2e-4 / atol 2e-5 of P11's quant/f32 (the anchor of the
    attention probes, a copy of K4's former design; full's bf16 dots sum
    in another order, ~1e-6 from it); on the tool's raw q masks equals full
    to max abs error 0.
    -> (P12 row, P13 row)."""
    from llm_mixed_q_torch.kernels.attention_decode import packed_attention_decode_batch_cuda
    from llm_mixed_q_torch.ops.quantizers import _block_fp_qdq
    from llm_mixed_q_torch.tools import aprobe, k3
    from llm_mixed_q_torch.tools.timing import cuda_ms

    b, s_len, hd, nh, nkv = 32, k3.S, k3.HD, k3.NH, k3.NKV
    check((k3.HD, k3.NKV, k3.REP, k3.BSK, k3.BSV, k3.PROB_Q) ==
          (aprobe.HD, aprobe.NKV, aprobe.REP, aprobe.BSK, aprobe.BSV, aprobe.PROB_Q),
          "P12/P13 and P11 differ in shape or quantizers")
    raw = k3.make_inputs(b, device="cuda")
    qq = _block_fp_qdq(raw[0].reshape(-1, hd), *ACTQ[1:], [1, ACTQ[0]], True).reshape(raw[0].shape)
    masks = k3.resident_masks(device="cuda")
    cache_bytes = sum(t.numel() * t.element_size() for t in raw[1:5])
    nbytes = cache_bytes + 8 * qq.numel() + 4 * b
    mask_bytes = 8 * nh * s_len  # the lanes the blocks read: one row's own lanes, from L2 after
    calls = {f"v2_{st}": (lambda inp, st=st: k3.attention_v2(*inp, st),
                          lambda inp, st=st: k3.attention_v2_plain(*inp, st)) for st in k3.STAGES}
    calls["v3_masks"] = (lambda inp: k3.attention_v3(*inp, *masks),
                         lambda inp: k3.attention_v3_plain(*inp, *masks))
    k4 = lambda inp: packed_attention_decode_batch_cuda(
        *inp, k3.BSK, k3.BSV, nkv=nkv, rep=k3.REP, prob_q=k3.PROB_Q)
    v2 = {"variants": {}, "beside_ms": {}}
    v3 = {"variants": {}, "beside_ms": {}}
    for pos_at in (s_len - 1, 100):
        pos = torch.full((b,), pos_at, dtype=torch.int32, device="cuda")
        inputs = (qq, *raw[1:5], pos)
        for label, (run, plain) in calls.items():
            got, want = run(inputs), plain(inputs)
            if label == "v2_dots":
                err = _close_to_max(got, want, 1e-3, f"probe_attention_v2 dots pos {pos_at}")
            else:
                err = (got - want).abs().max().item()
                check(torch.allclose(got, want, rtol=2e-4, atol=2e-5),
                      f"{label} pos {pos_at}: max err {err}")
            row = v3 if label == "v3_masks" else v2
            key = label if label == "v3_masks" else label[3:]
            rv = row["variants"].setdefault(key, {"max_abs_err": 0.0})
            rv["max_abs_err"] = max(rv["max_abs_err"], err)
            log(f"  {label} pos {pos_at}: max_abs_err={err:.3e} vs its plain version")
            if pos_at != s_len - 1:
                continue
            cols = b * nh * (s_len * nkv if label == "v2_dots" else s_len)
            b_ms, b_by = bound(nbytes + (mask_bytes if label == "v3_masks" else 0),
                               4 * hd * cols, peaks, bf16=True)
            rv.update(plain_ms=cuda_ms(lambda: plain(inputs), reps=3, flush=flush),
                      bound_ms=b_ms, bound_by=b_by, library_ms=None)
            log(f"  {label}: bound_ms={b_ms:.4f} ({b_by}) plain_ms={rv['plain_ms']:.4f}")
        anchor = aprobe.attention_probe(*inputs, "quant")
        for label, fn in (("v2_full", calls["v2_full"][0]), ("v3_masks", calls["v3_masks"][0]),
                          ("K4", k4)):
            got = fn(inputs)
            err = (got - anchor).abs().max().item()
            check(torch.allclose(got, anchor, rtol=2e-4, atol=2e-5),
                  f"{label} vs quant/f32 pos {pos_at}: max err {err}")
            key = "k4_vs_anchor_err" if label == "K4" else f"{label}_vs_anchor_err"
            row = v3 if label == "v3_masks" else v2
            row[key] = max(row.get(key, 0.0), err)
            log(f"  {label} within rtol 2e-4 / atol 2e-5 of P11's quant/f32 on quantized q, "
                f"pos {pos_at} (max abs err {err:.3e})")
        raw_in = (*raw[:5], pos)
        got, want = calls["v3_masks"][0](raw_in), calls["v2_full"][0](raw_in)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err == 0.0, f"v3_masks vs v2_full on raw q, pos {pos_at}: max abs err {err}")
        log(f"  v3_masks == v2_full on raw q, pos {pos_at} (max abs err {err})")
    kd = torch.randn((b, nkv, s_len, hd), device="cuda")
    vd = torch.randn_like(kd)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qq.reshape(b, nkv, 1, hd), kd, vd), flush=flush)
    for rv in (v2["variants"]["softmax"], v2["variants"]["full"], v3["variants"]["v3_masks"]):
        rv["library_ms"] = library_ms
    inputs = (qq, *raw[1:5], raw[5])  # every position filled
    for label, row in (("v2_full", v2), ("v3_masks", v3)):
        row["beside_ms"] = {label: cuda_ms(lambda: calls[label][0](inputs), flush=flush),
                            "K4": cuda_ms(lambda: k4(inputs), flush=flush)}
    log(f"  SDPA on a dequantized float32 cache: {library_ms:.4f} ms; one call each: "
        f"{v2['beside_ms']}, {v3['beside_ms']}")
    return v2, v3


def check_expand_probe(peaks, flush, lib_path):
    """P10 at the TPU probe's shape (L = 8192, b = 32, inputs from seed 0):
    every instance against its plain version (``none`` bit-exact; index
    and staged within 1e-5 of max|y|, as every product is exact they are
    bit-exact too), its plain time and bound; a batched bf16 ``torch.bmm``
    on the pre-dequantized w as its yardstick; and the LDG (global load)
    instructions of each instance's SASS: ``none`` must keep as many as
    ``index``, or the compiler dropped its scale loads. -> row."""
    from llm_mixed_q_torch.tools import kexp
    from llm_mixed_q_torch.tools.timing import cuda_ms

    l, b = 8192, 32
    q, codes, scales = kexp.make_inputs(l, b, device="cuda")
    nbytes = kexp.nbytes_of(l, b)
    b_ms, b_by = bound(nbytes, 2 * b * kexp.ROWS * kexp.HD * l, peaks, bf16=True)
    row = {"variants": {}}
    for v in kexp.VARIANTS:
        got, want = kexp.expand_probe(q, codes, scales, v), kexp.expand_probe_plain(q, codes, scales, v)
        if v == "none":
            torch.cuda.synchronize()
            check(torch.equal(got, want), "probe_expand none: not bit-exact")
            err = 0.0
        else:
            err = _close_to_max(got, want, 1e-5, f"probe_expand {v}")
        plain_ms = cuda_ms(lambda: kexp.expand_probe_plain(q, codes, scales, v), reps=3, flush=flush)
        row["variants"][v] = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=None)
        log(f"  probe_expand {v}: max_abs_err={err:.3e} bound_ms={b_ms:.4f} ({b_by}) "
            f"plain_ms={plain_ms:.4f}")
    w16 = (codes.float() * scales.repeat_interleave(kexp.BS, dim=1)).to(torch.bfloat16)
    q16 = q.to(torch.bfloat16)
    library_ms = cuda_ms(lambda: torch.bmm(q16, w16), flush=flush)
    for rv in row["variants"].values():
        rv["library_ms"] = library_ms
    del w16
    ldg = count_sass(lib_path, "expand_probe_kernel", "LDG")
    by_variant = {v: sum(c for name, c in ldg.items() if f"ILi{i}E" in name)
                  for i, v in enumerate(kexp.VARIANTS)}
    log(f"  bf16 torch.bmm on the pre-dequantized w: {library_ms:.4f} ms; LDG instructions "
        f"by instance: {by_variant}")
    check(by_variant["none"] >= by_variant["index"] > 0,
          f"probe_expand none lost its scale loads: {by_variant}")
    row["sass_ldg"] = by_variant
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
    without activation quantizer: v2 and v4 equal K1 (transposed) or
    subbyte_tile's c32_t1 (K3's former CUDA-core design, which they copy)
    and P2 equals int8_tile's c32_k512 (K2's, which P2 copies) to max abs
    error 0, v3 and K3 and K2 on the tensor cores are within 1e-5 of max|y|
    of theirs; the production kernels timed beside them. -> {probe: row},
    sums over the four shapes."""
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
            ("", "lane_major", c32_t1, "c32_t1", peaks[1])):
        probes["probe_matmul_variant" + suffix] = (fmt, prod, pname, op_peak, mm)
        probes["probe_sub_variant" + suffix] = (fmt, prod, pname, op_peak, sub)
    probes["probe_int8_variant"] = ("int8", c32_k512, "c32_k512", peaks[1], {
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
            if fmt in ("int8", "lane_major"):
                tc, kern = (("K2", bfp_matmul_cuda) if fmt == "int8"
                            else ("K3", bfp_matmul_subbyte_cuda))
                err = _close_to_max(kern(x_bf, packed, None), want, 1e-5,
                                    f"{tc} vs {pname} {sname}")
                log(f"  {tc} {sname}: within 1e-5 of {pname} without actq on bf16 x "
                    f"(max abs err {err:.3e})")
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
                kern = {"int8": bfp_matmul_cuda, "lane_major": bfp_matmul_subbyte_cuda}.get(fmt, prod)
                prod_ms[fmt, sname] = cuda_ms(lambda: kern(x_bf, packed, None), flush=flush)
            _add(row["beside_ms"], {"int8": "K2", "lane_major": "K3"}.get(fmt, pname),
                 prod_ms[fmt, sname])
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
    every subbyte_tile instance equals c32_t1 (K3's former CUDA-core
    design) and every int8_tile instance without bands c32_k512 (K2's) to
    max abs error 0, the band instance within 1e-5 of max|y| of c32_k512,
    and K3 and K2 on the tensor cores within 1e-5 of their anchors.
    band_sum, on a workspace of the band instance's shape: equal to
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
                               kprobe.subbyte_tile_plain, c32_t1, "c32_t1"),
        "probe_int8_tile": ("int8", ktune7b.INT8_INSTANCES, ktune7b.int8_tile,
                            ktune7b.int8_tile_plain, c32_k512, "c32_k512"),
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
            tc, kern = ("k2", bfp_matmul_cuda) if fmt == "int8" else ("k3", bfp_matmul_subbyte_cuda)
            err = _close_to_max(kern(x_bf, packed, None), want, 1e-5,
                                f"{tc.upper()} vs {pname} {sname}")
            key = f"{tc}_vs_{pname}_err"
            rows[name][key] = max(rows[name].get(key, 0.0), err)
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


def run_probes(peaks, flush, probes_lib):
    """Phase 8: the probe kernels against their plain versions and their
    production kernels, then the eight probe entry points, each with the
    launch counters set to 0 before it and read after it. -> (probe rows,
    launch counts by probe path)."""
    from llm_mixed_q_torch.tools import (aprobe, k3, kexp, kprobe, ksub, ktune7b, kvariants,
                                         kvariants2, timing)

    t0 = time.perf_counter()
    log("probe kernels vs plain versions and vs their production kernels:")
    secs = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        secs[name] = round(time.perf_counter() - t, 1)
        return out

    rows = timed("check_subbyte", lambda: check_subbyte_probes(peaks, flush))
    rows.update(timed("check_variants", lambda: check_variant_probes(peaks, flush)))
    rows["probe_attention"] = timed("check_attention", lambda: check_attention_probe(peaks, flush))
    rows.update(timed("check_tiles", lambda: check_tile_probes(peaks, flush)))
    rows["probe_attention_v2"], rows["probe_attention_v3"] = timed(
        "check_k3", lambda: check_k3_probes(peaks, flush))
    rows["probe_expand"] = timed("check_expand",
                                 lambda: check_expand_probe(peaks, flush, probes_lib))

    # one timed chain of 100 calls a variant (the entry points' default is 3:
    # cut to 1 to leave the script's time limit room for the
    # parallel phase, 13)
    counts, times = {}, {}
    for path, run in (("ksub", lambda: ksub.run(ksub.SHAPES, reps=PROBE_REPS, log=log)),
                      ("kvariants", lambda: kvariants.run(ksub.SHAPES, reps=PROBE_REPS, log=log)),
                      ("kvariants2",
                       lambda: kvariants2.run(ksub.SHAPES, reps=PROBE_REPS, log=log)),
                      ("aprobe", lambda: aprobe.run(32, 256, reps=PROBE_REPS, log=log)),
                      ("kprobe", lambda: kprobe.run(ksub.SHAPES, reps=PROBE_REPS, log=log)),
                      ("ktune7b", lambda: ktune7b.run(ksub.SHAPES, reps=PROBE_REPS, log=log)),
                      ("k3", lambda: k3.run(32, reps=PROBE_REPS, log=log)),
                      ("kexp", lambda: kexp.run(8192, 32, reps=PROBE_REPS, log=log))):
        reset_all_launch_counts()
        torch.cuda.synchronize()
        times[path] = timed(path, run)
        torch.cuda.synchronize()
        counts[path] = all_launch_counts()
    check_path_counts(counts)
    log(f"phase 9's parts, seconds: {secs}")
    log("phase 9's entry points' set-up (inputs drawn, packed, copied; the rest is their "
        f"chains), seconds: { {k: round(v, 2) for k, v in timing.setup_seconds.items()} }")

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
    for v, rv in rows["probe_attention_v2"]["variants"].items():
        rv["ms"] = times["k3"][f"v2_{v}"]
    rows["probe_attention_v3"]["variants"]["v3_masks"]["ms"] = times["k3"]["v3_masks"]
    for name in ("probe_attention_v2", "probe_attention_v3"):
        rows[name]["beside_ms"]["K4, k3 run"] = times["k3"]["K4"]
    # an instance's ms: that of the TPU names it runs (timed once for all)
    for name, instance in kexp.ALIASES.items():
        rows["probe_expand"]["variants"][instance]["ms"] = times["kexp"][name]
    rows["probe_expand"]["aliases"] = kexp.ALIASES
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
    log(f"phase 9 (probes) took {time.perf_counter() - t0:.1f} s")
    return rows, counts


# the serving-tail and BERT phase (10); its device is a name of its own so
# that the phase can be rehearsed on the CPU with the plain versions
TAIL_DEVICE = "cuda"
# depth cut: 4 layers on the card, 1 against the CPU (2 until phase 13
# needed the time)
TAIL_LAYERS, TAIL_CPU_LAYERS = 4, 1
TAIL_PREFILL, TAIL_STEPS, TAIL_CPU_STEPS = 32, 16, 2
# BERT-base as published in bert-base-uncased's config.json, with a 2-label head
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12, hidden_act="gelu", num_labels=2)
BERT_BATCH, BERT_SEQ = 2, 128  # 256 rows: the most rows bfp_matmul sends to the kernels
BERT_SHAPES = {"attention": (768, 768), "intermediate": (3072, 768), "output": (768, 3072)}
BERT_ACTQ = (16, 4, 8, 127)  # data_in block_fp of bfp_4bit.toml
BERT_EVAL_SAMPLES, BERT_EVAL_BATCH = 256, 8
BERT_TASKS = ("cls", "mlm", "clm", "nsp", "pretrain", "mc", "token", "qa")
# quantized logits of two float32 orders: a sum in another order flips a
# rounding of a re-quantized activation now and then (run_llama's decode gate)
QUANT_GATE = 5e-2
# the largest quantized-arm logit gap, card against CPU, that the perplexity
# phase's 2-layer forwards have shown (PERF.md §6)
PPL_QUANT_GAP = 0.66


def _rel(got, want):
    """max|got - want| / max|want|, both on one device."""
    return ((got - want).abs().max() / want.abs().max()).item()


def _stitch(prefill, decode, params, ids, mask, steps):
    """Prefill TAIL_PREFILL tokens, then decode ``steps`` one at a time.
    -> (stitched logits [b, TAIL_PREFILL + steps, vocab], ms a decode step)"""
    logits, kvs = prefill(params, ids[:, :TAIL_PREFILL], mask[:, :TAIL_PREFILL])
    outs = [logits]
    _sync()
    t0 = time.perf_counter()
    for t in range(TAIL_PREFILL, TAIL_PREFILL + steps):
        logits, kvs = decode(params, ids[:, t:t + 1], mask[:, :t + 1], kvs)
        outs.append(logits)
    _sync()
    return torch.cat(outs, 1), (time.perf_counter() - t0) / steps * 1e3


def _sync():
    if TAIL_DEVICE == "cuda":
        torch.cuda.synchronize()


def _on(tree, device):
    from llm_mixed_q_torch.models.hf_loader import tree_map_tensors

    return tree_map_tensors(lambda t: t.to(device), tree)


def _tail_inputs(n_steps, vocab):
    """Ids [8, TAIL_PREFILL + n_steps]; row 1 right-padded in the prefill."""
    rng = np.random.default_rng(SEED + 10)
    ids = torch.as_tensor(rng.integers(2, vocab, (BATCH, TAIL_PREFILL + n_steps)),
                          device=TAIL_DEVICE)
    mask = torch.ones_like(ids)
    mask[1, 20:TAIL_PREFILL] = 0
    return ids, mask


def tail_incremental():
    """Part 1a: ``make_prefill_and_decode`` at Llama-2-7B widths, 4 layers:
    float32 stitched against the full forward (rtol/atol 2e-4); W6A6 on
    sub-byte packed weights (K1) with the launch counters around it,
    against the plain path and the full forward (gaps), ms a decode step;
    ``generate_greedy`` against ``generate``. -> (results, launch counts)"""
    from llm_mixed_q_torch.models.api import make_forward, make_prefill_and_decode
    from llm_mixed_q_torch.models.hf_loader import init_llama_params
    from llm_mixed_q_torch.models.llama import generate, generate_greedy

    out = {}
    ids, mask = _tail_inputs(TAIL_STEPS, VOCAB)
    rows = mask.bool()
    cfg32 = _qat_config("llama", TAIL_LAYERS, "bypass")
    p32 = init_llama_params(cfg32, seed=SEED, device=TAIL_DEVICE)
    prefill, decode = make_prefill_and_decode("llama", "lm", cfg32)
    stitched, out["fp32_decode_step_ms"] = _stitch(prefill, decode, p32, ids, mask, TAIL_STEPS)
    full = make_forward("llama", "lm", cfg32)(p32, ids, mask)["logits"]
    check(torch.allclose(stitched[rows], full[rows], rtol=2e-4, atol=2e-4),
          f"fp32 stitched logits differ from the full forward: {_rel(stitched[rows], full[rows])}")
    out["fp32_stitched_vs_full"] = _rel(stitched[rows], full[rows])
    del p32, full, stitched
    torch.cuda.empty_cache()

    cfg = _qat_config("llama", TAIL_LAYERS, "bfp_6bit")
    sub = init_llama_params(cfg, seed=SEED, device=TAIL_DEVICE,
                            pack=dict(subbyte=True, bf16_embed=True))
    prefill, decode = make_prefill_and_decode("llama", "lm", cfg)
    _stitch(prefill, decode, sub, ids, mask, 2)  # first use of each shape
    reset_all_launch_counts()
    stitched, out["decode_step_ms"] = _stitch(prefill, decode, sub, ids, mask, TAIL_STEPS)
    counts = {"prefill_and_decode": all_launch_counts()}
    with plain_path():
        plain, out["plain_decode_step_ms"] = _stitch(prefill, decode, sub, ids, mask, TAIL_STEPS)
    out["kernel_vs_plain"] = _rel(stitched[rows], plain[rows])
    check(out["kernel_vs_plain"] <= QUANT_GATE,
          f"W6A6 stitched logits, kernels against plain: {out['kernel_vs_plain']}")
    full = make_forward("llama", "lm", cfg)(sub, ids, mask)["logits"]
    out["w6a6_stitched_vs_full"] = _rel(stitched[rows], full[rows])
    out["argmax_agreement_vs_full"] = (stitched[rows].argmax(-1) == full[rows].argmax(-1)
                                       ).float().mean().item()
    log(f"  make_prefill_and_decode, Llama-2-7B widths, {TAIL_LAYERS} layers, batch {BATCH}, "
        f"prefill {TAIL_PREFILL} + {TAIL_STEPS} steps: fp32 stitched vs full forward "
        f"{out['fp32_stitched_vs_full']:.3e} of max|logit| (fp32 step "
        f"{out['fp32_decode_step_ms']:.2f} ms); W6A6 sub-byte decode step "
        f"{out['decode_step_ms']:.2f} ms (plain path {out['plain_decode_step_ms']:.2f}), "
        f"kernels vs plain {out['kernel_vs_plain']:.3e}, stitched vs full forward "
        f"{out['w6a6_stitched_vs_full']:.3e} (argmax agreement "
        f"{out['argmax_agreement_vs_full']:.3f}; matmul_0 quantizes k^T in blocks of positions)")
    del full, plain, stitched
    prompts, pmask = ids[:, :TAIL_PREFILL].cpu().numpy(), mask[:, :TAIL_PREFILL].cpu().numpy()
    greedy = generate_greedy(sub, cfg, prompts, pmask, 8, 64, device=TAIL_DEVICE)
    check(np.array_equal(greedy, generate(sub, cfg, prompts, pmask, max_new_tokens=8, max_len=64,
                                          temperature=0.0, device=TAIL_DEVICE)),
          "generate_greedy differs from generate at temperature 0")
    del sub
    torch.cuda.empty_cache()
    return out, counts


def tail_warmup():
    """Part 1b: ``ContinuousBatcher.warmup`` on the 7B batcher of run_llama's
    shape (8 slots, max_len 512, head-major cache, int8 weights: K2 +
    actq_split + K5), 4 layers: its seconds and launches; the admissions'
    ms after it; every output equal to a batcher's without it.
    -> (results, launch counts)"""
    from llm_mixed_q_torch.models.hf_loader import init_llama_params
    from llm_mixed_q_torch.models.llama import ContinuousBatcher

    cfg = _qat_config("llama", TAIL_LAYERS, "bfp_6bit")
    int8 = init_llama_params(cfg, seed=SEED, device=TAIL_DEVICE,
                             pack=dict(subbyte=False, bf16_embed=True))
    prompts, _, _ = ragged_prompts(np.random.default_rng(SEED + 11), 16, VOCAB)
    out, counts = {}, {}

    def serve(warm):
        srv = ContinuousBatcher(int8, cfg, num_slots=8, max_len=512, max_new_tokens=32,
                                prompt_bucket=32, device=TAIL_DEVICE)
        check(not srv.cache.pos_major, "the 7B batcher's cache is not head-major")
        admits, admit = [], srv._admit

        def timed_admit():
            queued = len(srv._queue)
            _sync()
            t0 = time.perf_counter()
            admit()
            _sync()
            if len(srv._queue) < queued:
                admits.append((time.perf_counter() - t0) * 1e3)

        srv._admit = timed_admit
        if warm:
            reset_all_launch_counts()
            _sync()
            t0 = time.perf_counter()
            srv.warmup()
            _sync()
            out["warmup_s"] = time.perf_counter() - t0
            counts["warmup"] = all_launch_counts()
            live = [t for f in srv.cache[:4] for t in f] + [srv._positions, srv._last_tok]
            check(all(int(t.count_nonzero()) == 0 for t in live),
                  "warmup wrote into the live state")
        for p in prompts:
            srv.submit(p)
        return srv.run(), admits

    warm_out, out["admission_ms"] = serve(True)
    cold_out, out["admission_ms_without_warmup"] = serve(False)
    check(warm_out == cold_out, "an output with warmup differs from the output without it")
    log(f"  ContinuousBatcher.warmup (7B widths, {TAIL_LAYERS} layers, 8 slots, max_len 512, "
        f"head-major, int8): {out['warmup_s']:.2f} s for 16 buckets and a decode chunk; "
        f"admissions after it {[round(a, 2) for a in out['admission_ms']]} ms, without it "
        f"{[round(a, 2) for a in out['admission_ms_without_warmup']]} ms; outputs equal")
    del int8
    torch.cuda.empty_cache()
    return out, counts


def _tree_nbytes(tree):
    from llm_mixed_q_torch.models.hf_loader import tree_map_tensors

    sizes = []
    tree_map_tensors(lambda t: sizes.append(t.numel() * t.element_size()), tree)
    return sum(sizes)


def _trees_equal(a, b):
    from llm_mixed_q_torch.models.hf_loader import tree_map_tensors

    la, lb = [], []
    tree_map_tensors(la.append, a)
    tree_map_tensors(lb.append, b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def tail_host_and_cpu():
    """Part 1c: ``pack_llama_params_host`` against ``pack_llama_params`` on
    the card, from one float tree on the host (Llama-2-7B widths,
    ``TAIL_CPU_LAYERS`` layers): every packed leaf bit-equal, seconds a
    layer, the native engine's calls, the bytes moved. Part 1d: the
    incremental path card against CPU at ``TAIL_CPU_LAYERS`` layers, Llama
    and OPT-6.7B widths: float32 within 1e-4
    of max|logit|, W6A6 packed within QUANT_GATE. -> results"""
    from llm_mixed_q_torch.models.api import make_prefill_and_decode
    from llm_mixed_q_torch.models.hf_loader import init_llama_params, init_opt_params
    from llm_mixed_q_torch.models.llama import pack_llama_params, pack_llama_params_host
    from llm_mixed_q_torch.models.opt.pack import pack_opt_params
    from llm_mixed_q_torch.native import native_calls, reset_native_calls

    out = {"host_pack": {}, "card_vs_cpu": {}}
    cfg = _qat_config("llama", TAIL_CPU_LAYERS, "bfp_6bit")
    host_tree = init_llama_params(cfg, seed=SEED, device="cpu")
    float_bytes = _tree_nbytes(host_tree)
    packed = {}
    for subbyte in (True, False):
        kw = dict(subbyte=subbyte, bf16_embed=True, device=TAIL_DEVICE)
        reset_native_calls()
        t0 = time.perf_counter()
        host = pack_llama_params_host(host_tree, cfg, **kw)
        _sync()
        t_host = time.perf_counter() - t0
        calls = native_calls()
        t0 = time.perf_counter()
        dev = pack_llama_params(host_tree, cfg, **kw)
        _sync()
        t_dev = time.perf_counter() - t0
        check(calls > 0, "the native pack engine was not used")
        check(_trees_equal(host, dev), f"host-packed leaves differ from device-packed (subbyte "
                                       f"{subbyte})")
        name = "subbyte" if subbyte else "int8"
        out["host_pack"][name] = {
            "host_s_a_layer": t_host / TAIL_CPU_LAYERS, "device_s_a_layer": t_dev / TAIL_CPU_LAYERS,
            "native_calls": calls, "bytes_moved": _tree_nbytes(host), "float_bytes": float_bytes}
        log(f"  pack_llama_params_host ({name}, 7B widths, {TAIL_CPU_LAYERS} layers, embeddings "
            f"included): {t_host / TAIL_CPU_LAYERS:.2f} s a layer, {calls} native calls, "
            f"{_tree_nbytes(host) / 1e9:.3f} GB moved (float32 tree {float_bytes / 1e9:.3f} GB); "
            f"pack_llama_params on the card {t_dev / TAIL_CPU_LAYERS:.2f} s a layer; every "
            f"leaf bit-equal")
        packed[name] = host
        del dev
    packed = packed["subbyte"]
    torch.cuda.empty_cache()

    def card_vs_cpu(arch, label, cfg, card_tree, gate):
        prefill, decode = make_prefill_and_decode(arch, "lm", cfg)
        vocab = cfg.vocab_size
        ids, mask = _tail_inputs(TAIL_CPU_STEPS, vocab)
        got, _ = _stitch(prefill, decode, card_tree, ids, mask, TAIL_CPU_STEPS)
        want, _ = _stitch(prefill, decode, _on(card_tree, "cpu"), ids.cpu(), mask.cpu(),
                          TAIL_CPU_STEPS)
        rows = mask.cpu().bool()
        gap = _rel(got.cpu()[rows], want[rows])
        out["card_vs_cpu"][label] = gap
        log(f"  incremental {label}, {TAIL_CPU_LAYERS} layers, card vs CPU: {gap:.3e} of "
            f"max|logit| (gate {gate})")
        check(gap <= gate, f"{label}: card and CPU differ by {gap}")

    card_vs_cpu("llama", "llama_w6a6_subbyte", cfg, packed, QUANT_GATE)
    del packed
    card_vs_cpu("llama", "llama_fp32", _qat_config("llama", TAIL_CPU_LAYERS, "bypass"),
                _on(host_tree, TAIL_DEVICE), 1e-4)
    del host_tree
    torch.cuda.empty_cache()
    opt_cfg = _ppl_config("opt", TAIL_CPU_LAYERS, "bfp_6bit")
    opt_tree = init_opt_params(opt_cfg, seed=SEED, device="cpu")
    card_vs_cpu("opt", "opt_fp32", _ppl_config("opt", TAIL_CPU_LAYERS, "bypass"),
                _on(opt_tree, TAIL_DEVICE), 1e-4)
    card_vs_cpu("opt", "opt_w6a6_subbyte", opt_cfg, pack_opt_params(opt_tree, opt_cfg,
                                                             device=TAIL_DEVICE), QUANT_GATE)
    del opt_tree
    torch.cuda.empty_cache()
    return out


def _bert_flat(tree):
    """The port's BERT cls tree under HF BertForSequenceClassification's
    names (CPU tensors)."""
    flat = {}

    def put(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                put(f"{prefix}{k}.", v)
            else:
                flat[prefix + k] = v.cpu().contiguous()

    put("bert.embeddings.", tree["embeddings"])
    for i, layer in enumerate(tree["layers"]):
        lp = f"bert.encoder.layer.{i}."
        for n in ("query", "key", "value"):
            put(f"{lp}attention.self.{n}.", layer["attention"][n])
        put(f"{lp}attention.output.", layer["attention"]["output"])
        put(f"{lp}intermediate.", layer["intermediate"])
        put(f"{lp}output.", layer["output"])
    put("bert.pooler.", tree["pooler"])
    put("classifier.", tree["classifier"])
    return flat


def _fwd_ms(fn, reps=5):
    """Card ms of a call (CUDA events over ``reps`` calls after one)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync()
    return start.elapsed_time(end) / reps


def bert_matmuls(peaks, flush):
    """K1 and K2 (with its actq_split) at BERT-base's three linear shapes
    and 256 rows, W4A4 (bfp_4bit): each against its plain version (1e-4 of
    max|y|), its ms, plain ms, bound (bytes, or operations at the bf16
    peak) and the bf16 matmul on the pre-dequantized weight.
    -> {kernel: {shape: row}}"""
    from llm_mixed_q_torch.kernels.dequant_matmul import (
        bfp_matmul_cuda, bfp_matmul_plain, bfp_matmul_subbyte_t_cuda)
    from llm_mixed_q_torch.kernels.packing import (
        pack_block_fp, pack_block_fp_subbyte_t, packed_nbytes, unpack)
    from llm_mixed_q_torch.models.pack_common import _k_stride
    from llm_mixed_q_torch.tools.timing import cuda_ms

    gen = torch.Generator(device=TAIL_DEVICE).manual_seed(SEED + 12)
    m = BERT_BATCH * BERT_SEQ
    res = {"bfp_matmul_subbyte_t": {}, "bfp_matmul_int8": {}}
    for sname, (n, k) in BERT_SHAPES.items():
        w = torch.randn((n, k), generator=gen, device=TAIL_DEVICE) * 0.02
        x = torch.randn((m, k), generator=gen, device=TAIL_DEVICE)
        for kname, wrapper, packed in (
                ("bfp_matmul_subbyte_t", bfp_matmul_subbyte_t_cuda,
                 pack_block_fp_subbyte_t(w, 4, 8, 127, [1, 16])),
                ("bfp_matmul_int8", bfp_matmul_cuda,
                 pack_block_fp(w, 4, 8, 127, [1, 16], k_stride=_k_stride(16, k)))):
            y, ref = wrapper(x, packed, BERT_ACTQ), bfp_matmul_plain(x, packed, BERT_ACTQ)
            err = _close_to_max(y, ref, 1e-4, f"{kname} BERT {sname} N={n} K={k} M={m}")
            w_bf16 = unpack(packed, torch.bfloat16)
            x_bf16 = x.to(torch.bfloat16)
            b_bytes = (packed_nbytes(packed) + 4 * m * (k + n)) / peaks[0] * 1e3
            b_ops = 2 * m * n * k / peaks[2] * 1e3
            row = {"n": n, "k": k, "m": m, "max_abs_err": err,
                   "ms": cuda_ms(lambda: wrapper(x, packed, BERT_ACTQ), flush=flush),
                   "plain_ms": cuda_ms(lambda: bfp_matmul_plain(x, packed, BERT_ACTQ), reps=5,
                                       flush=flush),
                   "library_ms": cuda_ms(lambda: torch.matmul(x_bf16, w_bf16.t()), flush=flush),
                   "bound_ms": max(b_bytes, b_ops),
                   "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
            res[kname][sname] = row
            log(f"  {kname} BERT {sname} N={n} K={k} M={m}: max_abs_err={err:.3e} "
                f"kernel_ms={row['ms']:.4f} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f}")
    return res


def tail_bert(peaks, flush):
    """Part 2, BERT-base (random weights, seed 0; a 2-label head; W4A4
    bfp_4bit): the PTQ forward card against CPU at 2 x 128; packed
    sub-byte (K1) and int8 (K2 + actq_split) forwards at 256 rows with the
    launch counters around each, against the plain path and the fake-quant
    forward; K1 and K2 at BERT's shapes; the GLUE eval through
    ``build_model`` on the synthetic stream, PTQ and packed (1024 rows a
    batch: no kernel); the eight heads once. -> (results, launch counts)"""
    import argparse

    from llm_mixed_q_torch.cli.common import build_model
    from llm_mixed_q_torch.datasets import make_synthetic_cls_dataset, numpy_dataloader
    from llm_mixed_q_torch.eval import eval_cls_glue
    from llm_mixed_q_torch.models.bert import (
        BertQuantizedConfig, bert_for_sequence_classification, pack_bert_params,
        quantize_bert_params_ptq)
    from llm_mixed_q_torch.models import get_model_fn
    from llm_mixed_q_torch.models.hf_loader import init_bert_params

    out, counts = {"card_vs_cpu": {}, "forward_ms": {}}, {}
    cfg = BertQuantizedConfig(**BERT_BASE, quant_config=_toml("bfp_4bit"))
    cfg32 = BertQuantizedConfig(**BERT_BASE)
    tree = init_bert_params(cfg, task="cls", seed=SEED, device=TAIL_DEVICE)
    rng = np.random.default_rng(SEED + 13)
    ids = torch.as_tensor(rng.integers(1, BERT_BASE["vocab_size"], (BERT_BATCH, BERT_SEQ)))
    mask = torch.ones_like(ids)
    mask[1, 100:] = 0
    tt = torch.zeros_like(ids)
    tt[:, BERT_SEQ // 2:] = 1
    dev_in = [t.to(TAIL_DEVICE) for t in (ids, mask, tt)]

    def fwd(params, config, inputs=dev_in, **kw):
        return bert_for_sequence_classification(params, *inputs, config=config, **kw)["logits"]

    with torch.no_grad():
        # PTQ trees prepared on the card, their bits copied to the CPU (as the
        # perplexity phase does): the CPU quantizes no weight
        for label, config, gate in (("bypass", cfg32, 1e-4), ("bfp_4bit", cfg, PPL_QUANT_GAP)):
            ptq = quantize_bert_params_ptq(tree, config)
            gap = _rel(fwd(ptq, config, quantize_weights=False).cpu(),
                       fwd(_on(ptq, "cpu"), config, (ids, mask, tt), quantize_weights=False))
            out["card_vs_cpu"][label] = gap
            log(f"  BERT-base fake-quant (PTQ) forward ({label}), card vs CPU: {gap:.3e} of "
                f"max|logit| (gate {gate})")
            check(gap <= gate, f"BERT {label}: card and CPU differ by {gap}")
            del ptq
        fake = fwd(tree, cfg)
        out["forward_ms"]["fake_quant"] = _fwd_ms(lambda: fwd(tree, cfg))
        for path, subbyte in (("bert_packed_t", True), ("bert_packed_int8", False)):
            packed = pack_bert_params(tree, cfg, subbyte=subbyte, device=TAIL_DEVICE)
            fwd(packed, cfg, quantize_weights=False)  # first use
            reset_all_launch_counts()
            got = fwd(packed, cfg, quantize_weights=False)
            _sync()
            counts[path] = all_launch_counts()
            with plain_path():
                plain = fwd(packed, cfg, quantize_weights=False)
            check(torch.allclose(plain, fake, rtol=5e-4, atol=5e-4),
                  f"{path}: the plain packed forward differs from the fake-quant one")
            out[path] = {"kernel_vs_plain": _rel(got, plain), "kernel_vs_fake": _rel(got, fake),
                         "plain_vs_fake": _rel(plain, fake)}
            check(out[path]["kernel_vs_plain"] <= QUANT_GATE,
                  f"{path}: kernels against plain {out[path]['kernel_vs_plain']}")
            out["forward_ms"][path] = _fwd_ms(lambda: fwd(packed, cfg, quantize_weights=False))
            with plain_path():
                out["forward_ms"][path + "_plain"] = _fwd_ms(
                    lambda: fwd(packed, cfg, quantize_weights=False), reps=2)
            if subbyte:
                out["profile_packed_t"] = profile_decode(
                    f"BERT-base packed sub-byte forward, {BERT_BATCH} x {BERT_SEQ}",
                    lambda i: fwd(packed, cfg, quantize_weights=False), steps=2)
            log(f"  {path}: {BERT_BATCH} x {BERT_SEQ} forward {out['forward_ms'][path]:.2f} ms "
                f"(plain path {out['forward_ms'][path + '_plain']:.2f}, fake-quant "
                f"{out['forward_ms']['fake_quant']:.2f}); logits kernels vs plain "
                f"{out[path]['kernel_vs_plain']:.3e}, vs fake-quant "
                f"{out[path]['kernel_vs_fake']:.3e}, plain vs fake-quant "
                f"{out[path]['plain_vs_fake']:.3e} of max|logit|")
            del packed
    out["matmuls"] = bert_matmuls(peaks, flush)

    ckpt = ROOT / "build" / "phase10_bert"
    ckpt.mkdir(parents=True, exist_ok=True)
    (ckpt / "config.json").write_text(json.dumps({**BERT_BASE, "model_type": "bert"}))
    torch.save(_bert_flat(tree), ckpt / "pytorch_model.bin")
    del tree, fake
    torch.cuda.empty_cache()
    ds = make_synthetic_cls_dataset(BERT_BASE["vocab_size"], BERT_SEQ, BERT_EVAL_SAMPLES,
                                    seed=SEED)
    out["eval"] = {}
    reset_all_launch_counts()
    for label, packed in (("ptq", False), ("packed", True)):
        args = argparse.Namespace(model_arch="bert", model_name=str(ckpt),
                                  quant_config=_toml("bfp_4bit"), num_labels=2, packed=packed,
                                  device=TAIL_DEVICE)
        _, params, eval_fwd = build_model(args, "cls")
        _sync()
        t0 = time.perf_counter()
        metrics = eval_cls_glue(eval_fwd, params, "sst2",
                                numpy_dataloader(ds, batch_size=BERT_EVAL_BATCH))
        _sync()
        secs = time.perf_counter() - t0
        check(0.0 <= metrics["accuracy"] <= 1.0, f"BERT eval metrics {metrics}")
        out["eval"][label] = {"metrics": metrics, "samples_per_s": BERT_EVAL_SAMPLES / secs}
        log(f"  eval_cls_glue (sst2, synthetic, {BERT_EVAL_SAMPLES} samples, batch "
            f"{BERT_EVAL_BATCH}) through build_model, {label}: {metrics}, "
            f"{BERT_EVAL_SAMPLES / secs:.1f} samples/s")
        del params
    counts["bert_eval"] = all_launch_counts()
    torch.cuda.empty_cache()

    out["heads"] = {}
    with torch.no_grad():
        for task in BERT_TASKS:
            params = init_bert_params(cfg, task=task, seed=SEED, device=TAIL_DEVICE)
            inputs = dev_in
            if task == "mc":  # two choices a question: the row and its rotation
                inputs = [torch.stack([t, t.roll(1, dims=1)], 1) for t in dev_in]
            labels = {"cls": {"labels": torch.tensor([0, 1])},
                      "mlm": {"labels": torch.where(dev_in[0] % 7 == 0, dev_in[0], -100)},
                      "clm": {"labels": dev_in[0]},
                      "nsp": {"labels": torch.tensor([0, 1])},
                      "pretrain": {"labels": torch.where(dev_in[0] % 7 == 0, dev_in[0], -100),
                                   "next_sentence_label": torch.tensor([1, 0])},
                      "mc": {"labels": torch.tensor([1, 0])},
                      "token": {"labels": dev_in[0] % 2},
                      "qa": {"start_positions": torch.tensor([3, 5]),
                             "end_positions": torch.tensor([9, 60])}}[task]
            res = get_model_fn("bert", task)(params, *inputs, config=cfg,
                                             **{k: v.to(TAIL_DEVICE) for k, v in labels.items()})
            shapes = {k: tuple(v.shape) for k, v in res.items()}
            check(all(bool(torch.isfinite(v).all()) for v in res.values()),
                  f"BERT {task} head: non-finite outputs")
            out["heads"][task] = {"loss": float(res["loss"]), "shapes": shapes}
            del params, res
    log(f"  the eight BERT heads at BERT-base widths: "
        f"{ {t: round(h['loss'], 4) for t, h in out['heads'].items()} } (losses, all finite)")
    torch.cuda.empty_cache()
    return out, counts


def run_tail(peaks, flush):
    """Phase 10, the serving tail and BERT, each part's kernels launched and
    counted between a reset and a reading. -> ({"tail": results}, launch
    counts by path)"""
    t0 = time.perf_counter()
    log(f"phase 10, part 1: the serving tail at Llama-2-7B widths ({TAIL_LAYERS} layers):")
    incremental, counts = tail_incremental()
    log(f"  (the incremental path took {time.perf_counter() - t0:.1f} s)")
    warm, warm_counts = tail_warmup()
    counts.update(warm_counts)
    log(f"  (with warmup, {time.perf_counter() - t0:.1f} s)")
    host = tail_host_and_cpu()
    t1 = time.perf_counter()
    log(f"part 1 took {t1 - t0:.1f} s; phase 10, part 2: BERT-base (W4A4 bfp_4bit):")
    bert, bert_counts = tail_bert(peaks, flush)
    counts.update(bert_counts)
    log(f"part 2 took {time.perf_counter() - t1:.1f} s")
    check_path_counts(counts)
    secs = time.perf_counter() - t0
    log(f"phase 10 (serving tail and BERT) took {secs:.1f} s")
    return {"tail": {"seconds": secs, "incremental": incremental, "warmup": warm,
                     "host_and_cpu": host, "bert": bert}}, counts


# phase 11 (--stats-only): statistic profiling on the float tree, the
# integer config it gives, the cost model, and the packed cache's route
STATS_LAYERS, STATS_BATCH, STATS_SEQ = 2, 2, 512  # part 1: depth cut to 2, card against CPU
# part 2: the paper's Section 1 protocol (experiments/emnlp/section_1_variance.py:32-60):
# 4 batches of 4 x 2048 tokens, variance_online on the activations, no weight stats
S1_BATCHES, S1_BATCH, S1_SEQ = 4, 4, 2048
STATS_FAMILIES = {  # part 1's widths: Llama-2-7B, OPT-6.7B, BERT-base
    "llama": dict(vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=INTER,
                  num_attention_heads=HEADS, max_position_embeddings=4096),
    "opt": dict(vocab_size=OPT_VOCAB, hidden_size=OPT_HIDDEN, ffn_dim=OPT_FFN,
                num_attention_heads=OPT_HEADS, max_position_embeddings=2048,
                do_layer_norm_before=True, activation_function="relu", enable_bias=True),
    "bert": {k: v for k, v in BERT_BASE.items() if k != "num_hidden_layers"},
}
STATS_TASKS = {"llama": "lm", "opt": "lm", "bert": "cls"}
STATS_ENTRIES = {"llama": 17, "opt": 21, "bert": 21}  # profile entries a layer
STATS_NODES = ("self_attn:q_proj", "self_attn:k_proj", "self_attn:v_proj", "self_attn:o_proj",
               "mlp:gate_proj", "mlp:down_proj", "mlp:up_proj")  # a Llama layer's profiled nodes
# part 5: the route of a packed KV cache at two public configs, depth cut to
# 2, each at 8192 positions. Meta-Llama-3-70B as its config.json has it: 64
# heads over 8 kv heads (rep 8) at head_dim 128, past the JAX package's cap
# on its kernel's cache (4096 x 128), within K5's limits: K5 takes it.
# mistralai/Mistral-Large-Instruct-2407 as its config.json has it (the Llama
# layer: no sliding window): 96 heads over 8 kv heads (rep 12), which both
# packages' kernels refuse: the dense route takes it.
LLAMA3_70B = dict(vocab_size=128256, hidden_size=8192, intermediate_size=28672,
                  num_attention_heads=64, num_key_value_heads=8, rope_theta=500000.0,
                  rms_norm_eps=1e-5, max_position_embeddings=8192)
MISTRAL_LARGE_2 = dict(vocab_size=32768, hidden_size=12288, intermediate_size=28672,
                       num_attention_heads=96, num_key_value_heads=8, rope_theta=1000000.0,
                       rms_norm_eps=1e-5, max_position_embeddings=131072)
# name: (widths, the route of its packed cache, the counter that route adds to)
F13_CONFIGS = {
    "fault13": (LLAMA3_70B, "kernel", "attn_decode_head_major"),
    "fault13_dense": (MISTRAL_LARGE_2, "dense", "attn_decode_packed_dense"),
}
F13_LAYERS, F13_PROMPT, F13_NEW, F13_MAX_LEN, F13_STEPS = 2, 32, 16, 8192, 8


def _profile_gaps(got, want):
    """Checks that two profiles have the same keys in the same order, the
    same stats and equal counts. -> the worst gaps: min / max / range over
    the entry's max|.|, variance relative, mean over |mean| + the entry's
    standard deviation."""
    check(list(got) == list(want), "the two profiles' keys or their order differ")
    gaps = {"min_max": 0.0, "mean": 0.0, "variance": 0.0}
    for name, stats in want.items():
        check(list(got[name]) == list(stats), f"{name}: the stats differ")
        rmm = stats.get("range_min_max", {})
        scale = max(abs(rmm.get("min", 0.0)), abs(rmm.get("max", 0.0)))
        for stat, values in stats.items():
            g = got[name][stat]
            check(list(g) == list(values), f"{name} {stat}: the fields differ")
            std = math.sqrt(values.get("variance", 0.0))
            for k, v in values.items():
                if k == "count":
                    check(g[k] == v, f"{name} {stat}: count {g[k]} != {v}")
                    continue
                den = {"mean": abs(v) + std, "variance": v}.get(k, scale)
                key = k if k in gaps else "min_max"
                gaps[key] = max(gaps[key], abs(g[k] - v) / den if den else abs(g[k] - v))
    return gaps


def _all_finite(tree):
    if isinstance(tree, dict):
        return all(_all_finite(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_all_finite(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


def stats_card_vs_cpu():
    """Part 1: Llama-2-7B, OPT-6.7B and BERT-base widths cut to 2 layers,
    random weights (seed 0), float: ``profile_statistics(model_fn=...)``
    with the CLI's defaults on the synthetic stream at 2 x 512, on the card
    and on the CPU from the same weights. Gates: the same keys in the same
    order (17 or 21 a layer), equal counts, min and max within 1e-4 of the
    entry's max|.|, variances within rtol 1e-3 and means within 1e-3 of
    |mean| + the standard deviation."""
    from llm_mixed_q_torch.datasets import make_synthetic_lm_dataset, numpy_dataloader
    from llm_mixed_q_torch.models import get_config_cls, get_model_fn
    from llm_mixed_q_torch.models.hf_loader import (
        init_bert_params, init_llama_params, init_opt_params)
    from llm_mixed_q_torch.stats import profile_statistics

    inits = {"llama": init_llama_params, "opt": init_opt_params, "bert": init_bert_params}
    out = {}
    for arch, widths in STATS_FAMILIES.items():
        config = get_config_cls(arch)(**widths, num_hidden_layers=STATS_LAYERS)
        task = STATS_TASKS[arch]
        cpu_tree = inits[arch](config, task=task, seed=SEED, device="cpu")
        card_tree = _on(cpu_tree, "cuda")
        ds = make_synthetic_lm_dataset(config.vocab_size, STATS_SEQ, STATS_BATCH, seed=SEED)
        batches = list(numpy_dataloader(ds, batch_size=STATS_BATCH))
        row = {}
        profiles = {}
        for side, tree in (("card", card_tree), ("cpu", cpu_tree)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            profiles[side] = profile_statistics(batches=batches, arch=arch,
                                                model_fn=get_model_fn(arch, task),
                                                config=config, params=tree)
            torch.cuda.synchronize()
            row[f"{side}_seconds"] = time.perf_counter() - t0
        check(len(profiles["card"]) == STATS_ENTRIES[arch] * STATS_LAYERS,
              f"{arch}: {len(profiles['card'])} profile entries")
        row.update(entries=len(profiles["card"]), **_profile_gaps(profiles["card"], profiles["cpu"]))
        log(f"  {arch}: {row['entries']} entries, card {row['card_seconds']:.2f} s, CPU "
            f"{row['cpu_seconds']:.2f} s; worst gaps min/max {row['min_max']:.3e}, mean "
            f"{row['mean']:.3e}, variance {row['variance']:.3e}")
        check(row["min_max"] <= 1e-4 and row["mean"] <= 1e-3 and row["variance"] <= 1e-3,
              f"{arch}: card and CPU profiles differ: {row}")
        out[arch] = row
        del cpu_tree, card_tree
    return out


def stats_section_1():
    """Parts 2 and 3: Llama-2-7B widths at 32 layers, float, random
    weights (seed 0). Part 2: the Section 1 protocol (4 batches of 4 x 2048
    tokens, variance_online on the activations, no weight stats), then the
    CLI's defaults on one batch: seconds, tokens/s, peak GB; gates: 32 x 17
    entries, every value finite. Part 3: that profile -> an 8-bit integer
    config (``transform_stat_profile_to_int_quant_config``, the Llama
    formatter and parser) -> ``eval_lm_wikitext2`` at seq 2048, one
    sequence, weights quantized every call, beside float32; gate: the loss
    finite."""
    from llm_mixed_q_torch.config import transform_stat_profile_to_int_quant_config
    from llm_mixed_q_torch.datasets import make_synthetic_lm_dataset
    from llm_mixed_q_torch.models import (
        get_config_cls, get_quant_config_parser, get_stat_config_formatter)
    from llm_mixed_q_torch.models.api import make_forward
    from llm_mixed_q_torch.models.hf_loader import init_llama_params
    from llm_mixed_q_torch.models.llama import llama_for_causal_lm
    from llm_mixed_q_torch.stats import profile_statistics

    widths = STATS_FAMILIES["llama"]
    config = get_config_cls("llama")(**widths, num_hidden_layers=LAYERS)
    t0 = time.perf_counter()
    params = init_llama_params(config, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    data = make_synthetic_lm_dataset(VOCAB, S1_SEQ, S1_BATCH * S1_BATCHES, seed=SEED)
    batches = [{k: v[i * S1_BATCH:(i + 1) * S1_BATCH] for k, v in data.items()}
               for i in range(S1_BATCHES)]
    runs = {}
    for name, kw, n in (("section_1", dict(act_stats=("variance_online",), weight_stats=()),
                         S1_BATCHES), ("cli_defaults", {}, 1)):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = profile_statistics(batches=batches[:n], arch="llama", model_fn=llama_for_causal_lm,
                                  config=config, params=params, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs[name] = {"seconds": secs, "tokens_per_s": n * S1_BATCH * S1_SEQ / secs,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "entries": len(prof)}
        check(len(prof) == LAYERS * STATS_ENTRIES["llama"], f"{name}: {len(prof)} entries")
        check(_all_finite(prof), f"{name}: a value is not finite")
        log(f"  {name}: {n} batch(es) of {S1_BATCH} x {S1_SEQ}, {len(prof)} entries, "
            f"{secs:.2f} s, {runs[name]['tokens_per_s']:.0f} tokens/s, peak "
            f"{runs[name]['peak_gb']:.2f} GB")
        if name == "section_1":
            # section_1_variance.py's reduction: a layer's mean data_in variance
            depth = [sum(prof[f"root:model_layer_{i}:{node}:data_in"]["variance_online"]["variance"]
                         for node in STATS_NODES) / len(STATS_NODES) for i in range(LAYERS)]
            runs[name]["variance_vs_depth"] = depth
            log(f"  variance vs depth (layers 0, 1, 15, 31): "
                f"{[round(depth[i], 6) for i in (0, 1, 15, 31)]}")
    runs["params_made_seconds"] = made

    qc = transform_stat_profile_to_int_quant_config(prof, "range_min_max", width=8)
    qc = get_quant_config_parser("llama")(get_stat_config_formatter("llama")(qc, LAYERS), LAYERS,
                                          strict=False)
    int_config = get_config_cls("llama")(**widths, num_hidden_layers=LAYERS, quant_config=qc)
    ds = make_synthetic_lm_dataset(VOCAB, S1_SEQ, 1, seed=SEED)
    evals = {}
    for name, cfg in (("float32", config), ("int8_from_stats", int_config)):
        res, _, secs, peak = _eval(make_forward("llama", "lm", cfg, with_labels=True), params, ds)
        check(math.isfinite(res["loss"]), f"{name}: loss {res['loss']}")
        evals[name] = {"loss": res["loss"], "perplexity": res["perplexity"], "seconds": secs,
                       "peak_gb": peak}
        log(f"  eval {name}: loss {res['loss']:.6f}, perplexity {res['perplexity']:.4f}, "
            f"{secs:.2f} s, peak {peak:.2f} GB")
    frac = {k: v for k, v in qc["model_layer_0"]["self_attn"]["q_proj"].items() if "frac" in k}
    log(f"  layer 0 q_proj's frac widths from the profile: {frac}")
    del params
    torch.cuda.empty_cache()
    return runs, {"evals": evals, "layer_0_q_proj": frac}



def stats_cost_model():
    """Part 4: the memory density of W6A6 (bfp_6bit) and W4A4 (bfp_4bit)
    at Llama-2-7B widths, seq 2048, and one layer's ``param_bits`` / 8
    beside the bytes of that layer packed by ``pack_llama_params`` (sub-byte
    words and int8 codes): a finding, not a gate."""
    from llm_mixed_q_torch.costmodel.profiler import compute_memory_density
    from llm_mixed_q_torch.models import get_config_cls, get_model_profiler
    from llm_mixed_q_torch.models.hf_loader import init_llama_params

    widths = STATS_FAMILIES["llama"]
    out = {}
    for stem in ("bfp_6bit", "bfp_4bit"):
        prof = get_model_profiler("llama")(
            get_config_cls("llama")(**widths, num_hidden_layers=LAYERS,
                                    quant_config=_toml(stem)), S1_SEQ)
        out[stem] = {"density": float(compute_memory_density(prof)),
                     **{k: int(v) for k, v in prof.items()}}
    one = get_config_cls("llama")(**widths, num_hidden_layers=1, quant_config=_toml("bfp_6bit"))
    bits = int(get_model_profiler("llama")(one, S1_SEQ)["param_bits"])
    for fmt, subbyte in (("subbyte", True), ("int8", False)):
        tree = init_llama_params(one, seed=SEED, device="cuda", pack=dict(subbyte=subbyte))
        layer = tree["layers"][0]
        nbytes = _tree_nbytes({"self_attn": layer["self_attn"], "mlp": layer["mlp"]})
        out[f"layer_packed_{fmt}"] = {"bytes": nbytes, "param_bits_over_8": bits / 8,
                                      "ratio": nbytes / (bits / 8)}
        del tree
    log(f"  density (32 * (params + acts) / bits) at seq {S1_SEQ}: bfp_6bit "
        f"{out['bfp_6bit']['density']:.4f}x, bfp_4bit {out['bfp_4bit']['density']:.4f}x; one "
        f"layer's packed bytes over param_bits / 8 ({bits / 8:.0f}): sub-byte "
        f"{out['layer_packed_subbyte']['ratio']:.4f}, int8 {out['layer_packed_int8']['ratio']:.4f}")
    return out


def _cache_bytes(cache):
    from llm_mixed_q_torch.models.llama.serving import PackedKVCache

    leaves = [t for field in cache[:4] for t in field] if isinstance(cache, PackedKVCache) else [cache]
    return sum(t.numel() * t.element_size() for t in leaves)


def _fault_13_config(name, widths, route, counter):
    """One config of part 5: ``generate`` with the default (packed) cache
    and with ``packed_kv=False``, each between a reset of the counters and a
    reading, then one decode step's logits and a profile of 4 + 4 steps
    (``profile_decode``) on each cache. Gates: the default cache is a
    ``PackedKVCache`` whose ``packed_decode_route`` is ``route``;
    ``counter`` (K5, or the dense route) counts 2 layers x 15 decode steps
    of the packed run; the tokens
    equal the float32 cache's; the step's logits within 1e-4 of max|logit|
    of the float32 cache's on the dense route, and within 5e-2 through K5
    (run_llama's gate of kernels against the plain path: ulp-level
    differences of float32 sums flip a rounding of the 6-bit re-quantized
    activations now and then). -> (results, launch counts by run)"""
    from llm_mixed_q_torch.kernels.attention_decode import packed_decode_route
    from llm_mixed_q_torch.models.hf_loader import init_llama_params
    from llm_mixed_q_torch.models.llama import (
        LlamaQuantizedConfig, decode_step, generate, prefill_into_cache)
    from llm_mixed_q_torch.models.llama.serving import (
        PackedKVCache, _cache_spec, _new_cache, packed_cache_layout)

    config = LlamaQuantizedConfig(**widths, num_hidden_layers=F13_LAYERS,
                                  quant_config=_toml("bfp_6bit"))
    got_route = packed_decode_route(config, F13_MAX_LEN, *packed_cache_layout(config, F13_MAX_LEN))
    check(got_route == route, f"{name}: the packed cache's route is {got_route}, not {route}")
    t0 = time.perf_counter()
    params = init_llama_params(config, seed=SEED, device="cuda",
                               pack=dict(subbyte=False, bf16_embed=True))
    torch.cuda.synchronize()
    log(f"  {name}: hidden {widths['hidden_size']}, {widths['num_attention_heads']} heads over "
        f"{widths['num_key_value_heads']} kv heads, {F13_LAYERS} layers, W6A6 int8 codes, bf16 "
        f"embedding, made in {time.perf_counter() - t0:.1f} s; the packed cache's route: {route}")
    ids = torch.as_tensor(np.random.default_rng(SEED + 16).integers(
        2, widths["vocab_size"], (1, F13_PROMPT)), device="cuda")
    mask = torch.ones_like(ids)
    out, counts, tokens, logits = {"route": route}, {}, {}, {}
    for cache_name, packed_kv in (("packed", None), ("float32", False)):
        path = f"{name}_{cache_name}"
        reset_all_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens[cache_name] = generate(params, config, ids, max_new_tokens=F13_NEW,
                                      max_len=F13_MAX_LEN, packed_kv=packed_kv, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts[path] = all_launch_counts()
        cache = _new_cache(config, 1, F13_MAX_LEN, _cache_spec(config, packed_kv), "cuda")
        check(isinstance(cache, PackedKVCache) == (packed_kv is None),
              f"{path}: cache {type(cache).__name__}")
        _, lengths = prefill_into_cache(params, ids, mask, cache, config)
        nxt = torch.as_tensor(tokens[cache_name][:, :1], device="cuda")
        logits[cache_name] = decode_step(params, nxt, cache, lengths, config)
        prof = profile_decode(f"{name}, {cache_name} cache", lambda i: decode_step(
            params, nxt, cache, lengths + 1 + i, config), steps=F13_STEPS // 2)
        out[cache_name] = {"generate_seconds": secs, "cache_bytes": _cache_bytes(cache),
                           "step_ms": prof["wall_ms"], "profile": prof,
                           "launches": counts[path]}
        log(f"  {cache_name} cache ({type(cache).__name__}, "
            f"{out[cache_name]['cache_bytes'] / 2**20:.1f} MiB): generate {secs:.2f} s, a decode "
            f"step {out[cache_name]['step_ms']:.2f} ms; launches "
            f"{ {k: c for k, c in counts[path].items() if c} }")
        del cache
    calls = counts[f"{name}_packed"][counter]
    check(calls == F13_LAYERS * (F13_NEW - 1),
          f"{name}: {counter} counted {calls}, not {F13_LAYERS * (F13_NEW - 1)}")
    check((tokens["packed"] == tokens["float32"]).all(),
          f"{name}: tokens differ: {tokens['packed']} vs {tokens['float32']}")
    gap = _rel(logits["packed"], logits["float32"])
    out["step_logit_gap"] = gap
    tol = 1e-4 if route == "dense" else 5e-2
    check(gap <= tol, f"{name}: a decode step's logits differ by {gap:.3e} of max|logit|")
    log(f"  tokens equal; a decode step's logits within {gap:.3e} of max|logit| (gate {tol})")
    del params
    torch.cuda.empty_cache()
    return out, counts


def stats_fault_13():
    """Part 5: the packed KV cache's route on the card, W6A6 (int8 codes:
    K2), bf16 embedding, random weights (seed 0), ``generate`` at batch 1, a
    32-token prompt, 16 new tokens, max_len 8192: Llama-3-70B widths through
    K5, Mistral-Large-2 widths through the dense route (``_fault_13_config``
    each); head_dims of 48 and 320, which K4 takes (``generate``'s default
    packed cache launches it, the dense route not at all; 320 since fault
    15's repair); and a head_dim of 6, which the JAX package's kernel
    takes and K4/K5 take since fault 18's repair: ``generate``'s default
    cache decodes through K4 at max_len 48 and through K5 at 4112 (2 kv
    heads past 8192 lanes), 2 layers x 3 steps each, the dense route 0,
    its tokens those of the float32 cache (``packed_kv=False``). ->
    (results, launch counts by run)"""
    from llm_mixed_q_torch.models.hf_loader import init_llama_params
    from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig, generate

    out, counts = {}, {}
    for name, (widths, route, counter) in F13_CONFIGS.items():
        out[name], run_counts = _fault_13_config(name, widths, route, counter)
        counts.update(run_counts)
    ids = torch.full((1, 4), 5, device="cuda")
    small = lambda hidden, max_len=48: LlamaQuantizedConfig(
        vocab_size=96, hidden_size=hidden, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=max_len, quant_config=_toml("bfp_6bit"))
    launches = {}
    for hd in (48, 320):
        config = small(2 * hd)
        params = init_llama_params(config, seed=SEED, device="cuda")
        reset_all_launch_counts()
        tokens = generate(params, config, ids, max_new_tokens=4, max_len=48, device="cuda")
        c = all_launch_counts()
        check(tokens.shape == (1, 4) and c["attn_decode_pos_major"] == 2 * 3
              and c["attn_decode_packed_dense"] == 0,
              f"head_dim {hd}: the packed cache did not decode through K4 ({c})")
        launches[hd] = out[f"head_dim_{hd}_k4_launches"] = c["attn_decode_pos_major"]
    hd6 = {}
    for max_len, kname in ((48, "attn_decode_pos_major"), (4112, "attn_decode_head_major")):
        config = small(12, max_len)
        params = init_llama_params(config, seed=SEED, device="cuda")
        reset_all_launch_counts()
        tokens = generate(params, config, ids, max_new_tokens=4, max_len=max_len,
                          device="cuda")
        c = all_launch_counts()
        f32 = generate(params, config, ids, max_new_tokens=4, max_len=max_len, packed_kv=False,
                       device="cuda")
        check(c[kname] == 2 * 3 and c["attn_decode_packed_dense"] == 0,
              f"head_dim 6, max_len {max_len}: the packed cache did not decode through "
              f"{kname} ({c})")
        check(bool((tokens == f32).all()), f"head_dim 6, max_len {max_len}: tokens {tokens} on "
                                        f"the packed cache, {f32} on the float32 cache")
        hd6[max_len] = {kname: c[kname], "tokens_equal": True}
    out["head_dim_6"] = hd6
    log(f"  head_dims 48 and 320 on the card: the packed cache decodes through K4 "
        f"({launches} launches, the dense route 0); head_dim 6 (fault 18's repair): through "
        f"K4 at max_len 48 and K5 at 4112 ({hd6}), the dense route 0, the float32 cache's "
        f"tokens")
    return out, counts


def run_stats():
    """Phase 11, the statistics path, its parts 1-4 with every counter set
    to 0 before them and read after them (no Hopper kernel: the float
    forward), part 5 (fault 13) with its own readings. -> ({"stats":
    results}, launch counts by run)"""
    t0 = time.perf_counter()
    reset_all_launch_counts()
    log(f"phase 11, part 1: profiles card vs CPU at {STATS_LAYERS} layers, {STATS_BATCH} x "
        f"{STATS_SEQ}:")
    card_vs_cpu = stats_card_vs_cpu()
    t1 = time.perf_counter()
    log(f"part 1 took {t1 - t0:.1f} s; phase 11, parts 2 and 3: Llama-2-7B widths, {LAYERS} "
        f"layers, the Section 1 protocol and the integer config from the profile:")
    section_1, int_config = stats_section_1()
    t2 = time.perf_counter()
    log(f"parts 2 and 3 took {t2 - t1:.1f} s; phase 11, part 4: the cost model:")
    cost = stats_cost_model()
    counts = {"stats": all_launch_counts()}
    t3 = time.perf_counter()
    log(f"part 4 took {t3 - t2:.1f} s; phase 11, part 5: the packed cache's route (fault 13):")
    fault_13, f13_counts = stats_fault_13()
    counts.update(f13_counts)
    log(f"part 5 took {time.perf_counter() - t3:.1f} s")
    check_path_counts(counts)
    secs = time.perf_counter() - t0
    log(f"phase 11 (statistics) took {secs:.1f} s")
    return {"stats": {"seconds": secs, "card_vs_cpu": card_vs_cpu, "section_1": section_1,
                      "int_config": int_config, "cost_model": cost,
                      "fault_13": fault_13}}, counts


# phase 12 (--search-only): fault 15's and fault 18's repairs (K4 and K5 at
# head_dims that are not powers of two: multiples of 16, 320, 40 and 8;
# since fault 18's, 6, a block of 12 and K5 past 1024 dims; all but the
# multiples of 16 held bit for bit), then the paper's search and the
# prompting eval. Row name: (head_dim, K/V block): 16 (every TOML's); 8 at
# 40, which 16 does not divide, and at 8 (16 cut to the head); 6 at 6 (16
# cut to the head); 12 at 48, neither a power of two nor the head
F15_SHAPES = {"hd48": (48, 16), "hd80": (80, 16), "hd96": (96, 16), "hd112": (112, 16),
              "hd320": (320, 16), "hd40": (40, 8), "hd8": (8, 8), "hd6": (6, 6),
              "hd48_bs12": (48, 12), "hd1280": (1280, 16)}
F15_BIT_EQUAL = ("hd320", "hd40", "hd8", "hd6", "hd48_bs12", "hd1280")
F15_REPS = (1, 8)
F15_NKV = 8
F15_LENS = {"attn_decode_pos_major": 1024, "attn_decode_head_major": 2048}  # max_len by layout
# fault 21's caches, which JAX's kernel takes and K4/K5 had no split for
# (name: head_dim, K/V block, prob block, kv heads, rep, max_len): head-major
# at 3012 dims, rep 8 and a scale a code (K5's scores in passes of 1004
# dims, P . V in 3 passes), at 5434 dims with one scale a head, and
# pos-major at 65536 dims (K4 took at most 65535)
F21_SHAPES = {"hd3012_s174": (3012, 1, 2, 48, 8, 174),
              "hd5434_one_scale": (5434, 5434, 16, 86, 8, 96),
              "pos_major_hd65536": (65536, 16, 8, 1, 1, 8)}
# a Llama-family config at head_dim 80: hidden 2560, 32 heads over 8 kv heads
F15_LLAMA = dict(vocab_size=VOCAB, hidden_size=2560, intermediate_size=6912,
                 num_attention_heads=32, num_key_value_heads=8, max_position_embeddings=4096)
F15_LAYERS, F15_BATCH, F15_PROMPT, F15_NEW = 2, 2, 32, 16
F15_MAX_LENS = {"attn_decode_pos_major": F15_PROMPT + F15_NEW, "attn_decode_head_major": 2048}
TIE = 1e-3  # two top logits within this share of max|logit|: a near tie


def _near_tie_ok(token, logits):
    """The card's token is the CPU's argmax, or its logit lies within TIE of
    max|logit| of the CPU's top one. token [b]; logits [b, vocab] (CPU)."""
    picked = logits.gather(1, token[:, None].long())[:, 0]
    return bool(((logits.max(1).values - picked) <= TIE * logits.abs().max()).all())


def search_head_dims(peaks, flush):
    """Part 1a: K4 and K5 against their plain versions at the head_dims and
    blocks of ``F15_SHAPES`` (48, 80, 96, 112, 320, 40 and 8; since fault
    18's repair 6, a block of 12 at 48 and 1280), rep 1 and 8, 8 kv heads,
    batch 8 (K4 at 1024 positions, the pos-major layout's 8192-lane cap; K5
    at 2048), then at fault 21's caches (``F21_SHAPES``, each config's
    route "kernel"; the prob quantizer off, and on, logged), each timed beside its plain version, its bound and SDPA on a
    dequantized cache (``_attention_row``, the tolerance of
    check_attention_kernels; bit for bit at ``F15_BIT_EQUAL``). ->
    {wrapper name: {"<shape>_rep<r>": row}}"""
    import tomllib

    from llm_mixed_q_torch.kernels.attention_decode import (
        k4_tiles, k5_tiles, packed_attention_decode_batch_cuda,
        packed_attention_decode_batch_plain, packed_attention_decode_cuda,
        packed_attention_decode_plain, packed_decode_route)
    from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig
    from llm_mixed_q_torch.models.llama.serving import packed_cache_layout
    from llm_mixed_q_torch.ops.quantizers import _block_fp_qdq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernels = {"attn_decode_pos_major": (True, packed_attention_decode_batch_cuda,
                                         packed_attention_decode_batch_plain),
               "attn_decode_head_major": (False, packed_attention_decode_cuda,
                                          packed_attention_decode_plain)}
    rows = {k: {} for k in kernels}

    def one(kname, label, hd, bs, nkv, rep, s_len, prob_q):
        pos_major, fn, plain = kernels[kname]
        positions = torch.tensor([(s_len - 1 - 9 * i) % s_len for i in range(BATCH)],
                                 dtype=torch.int32, device="cuda")
        cache = _cache_inputs(gen, s_len, nkv, hd, pos_major, bs)
        q = _block_fp_qdq(torch.randn((BATCH * nkv * rep, hd), generator=gen, device="cuda"),
                          6, 8, 127, [1, 16], True)
        kd = torch.randn((BATCH, nkv, s_len, hd), generator=gen, device="cuda")
        vd = torch.randn_like(kd)
        mask = (torch.arange(s_len, device="cuda")[None, None, None, :]
                <= positions.long()[:, None, None, None])
        library = lambda: sdpa(q.reshape(BATCH, nkv * rep, 1, hd), kd, vd, attn_mask=mask,
                               enable_gqa=rep > 1)
        if pos_major:
            args = (q.reshape(BATCH, nkv * rep, hd), *cache, positions, bs, bs, nkv, rep, prob_q)
            split = dict(zip(("dims", "dgs", "pgs"), k4_tiles(nkv, rep, hd, s_len, bs, bs)))
        else:
            args = (q.reshape(BATCH, nkv, rep, hd), *cache, positions, bs, bs, prob_q)
            split = dict(zip(("T", "dims", "dgs", "pgs"), k5_tiles(nkv, rep, hd, s_len, bs, bs)))
        r = _attention_row(f"{kname} {label}", lambda: fn(*args), lambda: plain(*args), library,
                           positions, nkv, rep, hd, peaks, flush, bs)
        r.update(split=split, nkv=nkv, max_len=s_len, block=bs)
        log(f"  {kname} head_dim {hd}, rep {rep} (nkv {nkv}, max_len {s_len}, block {bs}, "
            f"split {split}): max_abs_err={r['max_abs_err']:.3e} kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"library_ms(SDPA)={r['library_ms']:.4f}")
        del positions, cache, q, kd, vd, mask, library, args
        return r

    for kname in kernels:
        for (shape, (hd, bs)), rep in itertools.product(F15_SHAPES.items(), F15_REPS):
            r = one(kname, f"{shape}_rep{rep}", hd, bs, F15_NKV, rep, F15_LENS[kname], PROB_Q)
            if shape in F15_BIT_EQUAL:
                check(r["max_abs_err"] == 0.0, f"{kname} head_dim {hd}, rep {rep}: "
                                               f"{r['max_abs_err']} from its plain version")
            rows[kname][f"{shape}_rep{rep}"] = r
    # fault 21's caches: JAX's kernel takes them, and a config of that cache
    # routes to K4/K5 by its layout
    for name, (hd, bs, prob_bs, nkv, rep, s_len) in F21_SHAPES.items():
        qc = tomllib.loads(Path(_toml("bfp_6bit")).read_text())
        qc["default"]["weight_block_size"] = [1, bs]
        qc["default"]["data_in_block_size"] = [1, prob_bs]
        config = LlamaQuantizedConfig(
            vocab_size=96, hidden_size=hd * nkv * rep, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=nkv * rep, num_key_value_heads=nkv,
            max_position_embeddings=s_len, quant_config=qc)
        pos_major, blocks = packed_cache_layout(config, s_len)
        route = packed_decode_route(config, s_len, pos_major, blocks)
        check(blocks == (bs, bs) and route == "kernel", f"fault 21 {name}: {blocks} {route}")
        kname = "attn_decode_pos_major" if pos_major else "attn_decode_head_major"
        r = rows[kname][name] = one(kname, name, hd, bs, nkv, rep, s_len, None)
        # with the config's prob quantizer: a scale a code over 3012 dims
        # leaves the scores inexact in float32, so that the kernel's order
        # of sums against the plain version's may flip a rounding of the
        # 6-bit prob quantizer (as in K4 at 2048 dims); logged, held to the
        # tolerance with the quantizer off (above) and on at batch 2 in
        # tests/test_torch_cuda_kernels.py
        fn, plain = kernels[kname][1:]
        q = torch.randn((BATCH, nkv * rep, hd), generator=gen, device="cuda")
        q = _block_fp_qdq(q, 6, 8, 127, [1, 16], True)
        positions = torch.tensor([(s_len - 1 - 9 * i) % s_len for i in range(BATCH)],
                                 dtype=torch.int32, device="cuda")
        cache = _cache_inputs(gen, s_len, nkv, hd, pos_major, bs)
        pq = (prob_bs, 6, 8, 127)
        args = ((q, *cache, positions, bs, bs, nkv, rep, pq) if pos_major else
                (q.reshape(BATCH, nkv, rep, hd), *cache, positions, bs, bs, pq))
        got, want = fn(*args), plain(*args)
        r["prob_q_max_abs_err"] = (got - want).abs().max().item()
        r["prob_q_share_off"] = (~torch.isclose(got, want, rtol=2e-4, atol=2e-5)).float().mean().item()
        log(f"  {kname} {name} with its prob quantizer {pq}: max_abs_err="
            f"{r['prob_q_max_abs_err']:.3e}, share off the tolerance {r['prob_q_share_off']:.2e}")
        del q, positions, cache, args, got, want
    torch.cuda.empty_cache()
    return rows


def search_head_dim_80():
    """Part 1b: ``generate`` of a Llama-family config at head_dim 80 (hidden
    2560, 32 heads over 8 kv heads, 2 layers, W6A6 int8 codes, bf16
    embedding, random weights), batch 2, 32 prompt tokens and 16 new ones,
    on its default packed cache: at max_len 48 (pos-major: K4) and 2048
    (head-major: K5), each run between a reset of the counters and a
    reading, which must show its kernel launched and the dense route at 0.
    The card's tokens are held against the port on the CPU, teacher-forced
    on the card's tokens: each is the CPU's argmax or within TIE of its top
    logit (``_near_tie_ok``). -> (results, launch counts by run)"""
    from llm_mixed_q_torch.models.hf_loader import init_llama_params
    from llm_mixed_q_torch.models.llama import (
        LlamaQuantizedConfig, decode_step, generate, prefill_into_cache)
    from llm_mixed_q_torch.models.llama.serving import _cache_spec, _new_cache

    config = LlamaQuantizedConfig(**F15_LLAMA, num_hidden_layers=F15_LAYERS,
                                  quant_config=_toml("bfp_6bit"))
    check(config.head_dim == 80, f"head_dim {config.head_dim}")
    params = init_llama_params(config, seed=SEED, device="cuda",
                               pack=dict(subbyte=False, bf16_embed=True))
    cpu_params = _on(params, "cpu")
    ids = torch.as_tensor(np.random.default_rng(SEED + 15).integers(
        2, VOCAB, (F15_BATCH, F15_PROMPT)), device="cuda")
    mask = torch.ones_like(ids)
    out, counts = {}, {}
    for kname, max_len in F15_MAX_LENS.items():
        path = f"head_dim_80_{kname.removeprefix('attn_decode_')}"
        reset_all_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = generate(params, config, ids, mask, max_new_tokens=F15_NEW, max_len=max_len,
                          device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts[path] = all_launch_counts()
        check(counts[path][kname] == F15_LAYERS * (F15_NEW - 1)
              and counts[path]["attn_decode_packed_dense"] == 0,
              f"{path}: launches {counts[path]}")
        cache = _new_cache(config, F15_BATCH, max_len, _cache_spec(config, None), "cpu")
        logits, lengths = prefill_into_cache(cpu_params, ids.cpu(), mask.cpu(), cache, config)
        tok = torch.as_tensor(tokens, dtype=torch.int64)
        ties = 0
        for t in range(F15_NEW):
            exact = bool((logits.argmax(-1) == tok[:, t]).all())
            check(exact or _near_tie_ok(tok[:, t], logits),
                  f"{path}: token {t} of the card is neither the CPU's argmax nor a near tie")
            ties += not exact
            if t + 1 < F15_NEW:
                logits = decode_step(cpu_params, tok[:, t:t + 1], cache, lengths + t, config)
        out[path] = {"generate_seconds": secs, "near_ties": ties,
                     "launches": counts[path][kname]}
        log(f"  {path}: generate {secs:.2f} s at max_len {max_len}, {kname} launched "
            f"{counts[path][kname]} times, the dense route 0; every card token the CPU's "
            f"argmax on the card's history ({ties} near ties)")
    del params, cpu_params
    torch.cuda.empty_cache()
    return out, counts


# parts 2-4: the paper's search (configs/search/llama_7b_sst2.toml) at
# Llama-2-7B widths, depth cut to 4 layers (1 where card and CPU are held
# together), random weights, a 2-label head, make_synthetic_cls_dataset
# the CPU side of the card-against-CPU checks fake-quantizes ~0.2 G weights a
# layer a trial; one layer keeps the phase inside the script's time limit
SEARCH_LAYERS, SEARCH_CPU_LAYERS = 4, 1
SEARCH_TRIALS, COND_TRIALS, PROMPT_TRIALS = 6, 3, 3
# the card-against-CPU pair: the first 2 of the 6 trials (all 6 until phase
# 13 needed the time; the CPU side took 61.6 s of them)
SEARCH_CPU_TRIALS = 2
SEARCH_SAMPLES, SEARCH_CPU_SAMPLES, SEARCH_SEQ, SEARCH_BATCH = 64, 8, 128, 8
SEARCH_WIDTHS = dict(vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=INTER,
                     num_attention_heads=HEADS, max_position_embeddings=4096, num_labels=2)
COND_SPACE = {"name": ["integer"], "bypass": ["!ast!False"], "is_ptq": ["!ast!True"],
              "data_in_width": [8, 6], "weight_width": [8, 6, 4], "bias_width": [8],
              "data_out_width": [8]}
PROMPT_EXAMPLES, GREEDY_EXAMPLES, GREEDY_WORDS = 32, 4, 16


class ToyTokenizer:
    """Whitespace words as ids 2..VOCAB-1 (crc32), id 1 the start token: no
    tokenizer file is on the machine."""

    def __call__(self, text, add_special_tokens=True):
        import zlib

        ids = [1] if add_special_tokens else []
        return {"input_ids": ids + [2 + zlib.crc32(w.encode()) % (VOCAB - 2)
                                    for w in text.split()]}

    def decode(self, ids):
        return " ".join(f"t{i}" for i in ids)


def _search_config(layers, trials, space=None):
    """configs/search/llama_7b_sst2.toml cut to ``trials`` trials, seed 0
    (its TPE sampler, thresholds and space; ``space`` replaces the seed's
    default)."""
    from llm_mixed_q_torch.utils import load_config

    sc = load_config(ROOT / "configs/search/llama_7b_sst2.toml")
    sc["search_strategy"].update(n_trials=trials, seed=0)
    if space is not None:
        sc["search_space"] = {"quant_config_seed": {"default": dict(space)}}
    return sc


class _TrialClock(logging.Handler):
    """Seconds between a search's trial log records (each trial's own
    time, the first counted from ``start``)."""

    def __init__(self):
        super().__init__()
        self.start, self.times = time.time(), []

    def emit(self, record):
        if "rial" in record.getMessage():
            self.times.append(record.created)

    def seconds(self):
        ts = [self.start] + self.times
        return [b - a for a, b in zip(ts, ts[1:])]


@contextlib.contextmanager
def _trial_clock():
    clock = _TrialClock()
    logger = logging.getLogger("llm_mixed_q_torch.search")
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(clock)
    try:
        yield clock
    finally:
        logger.removeHandler(clock)
        logger.setLevel(level)


def _trial_rows(study, est, secs):
    rows = []
    for t, s in zip(study.trials, secs + [None] * len(study.trials)):
        mem = t.values[1] / (est["alpha_memory_density"] + 1e-8)
        rows.append({"trial": t.number, "seconds": s, "accuracy": t.values[0] / (
            est["alpha_accuracy"] + 1e-8), "memory_density": mem,
            "avg_bitwidth": est["compare_to"] / (mem + 1e-12)})
        log(f"    trial {t.number}: {rows[-1]['seconds'] or 0:.2f} s, accuracy "
            f"{rows[-1]['accuracy']:.4f}, memory density {mem:.4f}, avg bitwidth "
            f"{rows[-1]['avg_bitwidth']:.3f}")
    return rows


def _cls_search(cls, layers, trials, device, samples, save_dir, sc=None, init_device=None,
                **extra):
    """A classification search at Llama-2-7B widths on ``device``, its
    weights drawn on ``init_device`` (default ``device``; the CPU where the
    card's run is held against the CPU's: the generators differ): the
    study, the search object, its dataloader factory and its trial
    seconds."""
    from llm_mixed_q_torch.datasets import make_synthetic_cls_dataset, numpy_dataloader
    from llm_mixed_q_torch.models.hf_loader import init_llama_params
    from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig

    mck = dict(SEARCH_WIDTHS, num_hidden_layers=layers)
    params = _on(init_llama_params(LlamaQuantizedConfig(**mck), task="cls", seed=SEED,
                                   device=init_device or device), device)
    data = make_synthetic_cls_dataset(VOCAB, SEARCH_SEQ, samples, seed=SEED + 12)
    factory = lambda: numpy_dataloader(data, batch_size=SEARCH_BATCH)
    search = cls("llama", "llama-2-7b-widths", sc or _search_config(layers, trials), save_dir,
                 params, model_config_kwargs=mck, **extra)
    with _trial_clock() as clock:
        study = search.search(factory, "sst2", False, SEARCH_SEQ, samples)
    return study, search, factory, clock.seconds()


def _forward_logits(search, trial, ids, mask):
    from llm_mixed_q_torch.utils.trial_extractor import trial_to_quant_config

    cfg = search.make_model_config(search._trial_config(trial_to_quant_config(trial),
                                                        search.make_model_config(None)
                                                        .num_hidden_layers))
    with torch.inference_mode():
        return search.make_forward(cfg)(search.params, ids, mask)["logits"].float().cpu()


def search_cls(tmp):
    """Part 2: the classification search, TPE seed 0, 6 trials at 4 layers
    on 64 samples x 128 tokens, its trial seconds, accuracies, memory
    densities and average bitwidths and the peak device memory, then
    ``evaluate_best_trials``; the first 2 trials at 1 layer on 8 samples on
    the card and on the CPU: equal sampled configs and memory densities,
    and accuracies equal but for at most one sample a trial whose two top
    CPU logits lie within TIE of max|logit|. -> (results, launch counts)"""
    from llm_mixed_q_torch.datasets import make_synthetic_cls_dataset
    from llm_mixed_q_torch.search import SearchQuantisationForClassification as Search

    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    study, search, factory, secs = _cls_search(Search, SEARCH_LAYERS, SEARCH_TRIALS, "cuda",
                                               SEARCH_SAMPLES, tmp / "cls")
    est = search.search_config["search_estimator"]
    log(f"  classification search, {SEARCH_LAYERS} layers, {SEARCH_TRIALS} trials "
        f"(TPE seed 0), {SEARCH_SAMPLES} x {SEARCH_SEQ} tokens a trial:")
    rows = _trial_rows(study, est, secs)
    best = search.evaluate_best_trials(study, factory, "sst2")
    torch.cuda.synchronize()
    counts = {"search_cls": all_launch_counts()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(len(study.trials) == SEARCH_TRIALS and (tmp / "cls" / "results.csv").exists()
          and (tmp / "cls" / "best_quant_config.toml").exists(), "search artifacts missing")
    log(f"  evaluate_best_trials: {best}; peak device memory {peak:.2f} GB")
    del search, study
    torch.cuda.empty_cache()

    runs = {}
    for device in ("cuda", "cpu"):
        runs[device] = _cls_search(Search, SEARCH_CPU_LAYERS, SEARCH_CPU_TRIALS, device,
                                   SEARCH_CPU_SAMPLES, tmp / f"cls_{device}", init_device="cpu")
    (card, card_search, _, _), (cpu, cpu_search, _, cpu_secs) = runs["cuda"], runs["cpu"]
    check([t.params for t in card.trials] == [t.params for t in cpu.trials],
          "the card's sampled configs differ from the CPU's")
    check([t.values[1] for t in card.trials] == [t.values[1] for t in cpu.trials],
          "the card's memory densities differ from the CPU's")
    data = make_synthetic_cls_dataset(VOCAB, SEARCH_SEQ, SEARCH_CPU_SAMPLES, seed=SEED + 12)
    ids, mask = (torch.as_tensor(data[k]) for k in ("input_ids", "attention_mask"))
    flips = 0
    for a, b in zip(card.trials, cpu.trials):
        if a.values[0] == b.values[0]:
            continue
        got = _forward_logits(card_search, a, ids.cuda(), mask.cuda())
        want = _forward_logits(cpu_search, b, ids, mask)
        differ = (got.argmax(-1) != want.argmax(-1)).nonzero()[:, 0]
        check(len(differ) <= 1 and _near_tie_ok(got.argmax(-1)[differ], want[differ]),
              f"trial {a.number}: card and CPU predictions differ beyond a near tie")
        flips += len(differ)
    log(f"  the first {SEARCH_CPU_TRIALS} trials at {SEARCH_CPU_LAYERS} layer(s) on "
        f"{SEARCH_CPU_SAMPLES} samples, card vs CPU: sampled configs and memory densities "
        f"equal, {flips} near-tie flips of accuracy (CPU {sum(cpu_secs):.1f} s)")
    del runs, card_search, cpu_search
    torch.cuda.empty_cache()
    return {"trials": rows, "best": best, "peak_gb": peak, "card_vs_cpu_flips": flips}, counts


def search_conditional(tmp):
    """Part 3: the conditional (integer) search, 3 trials (TPE seed 0) at 4
    layers, on a stat profile taken here over 2 batches of the float
    classifier, then ``evaluate_best_trials``. -> (results, launch counts)"""
    from llm_mixed_q_torch.datasets import make_synthetic_cls_dataset, numpy_dataloader
    from llm_mixed_q_torch.models.hf_loader import init_llama_params
    from llm_mixed_q_torch.models.llama import (
        LlamaQuantizedConfig, llama_for_sequence_classification)
    from llm_mixed_q_torch.search import SearchIntQuantisationForClassification as Search
    from llm_mixed_q_torch.stats import profile_statistics

    reset_all_launch_counts()
    t0 = time.perf_counter()
    config = LlamaQuantizedConfig(**SEARCH_WIDTHS, num_hidden_layers=SEARCH_LAYERS)
    params = init_llama_params(config, task="cls", seed=SEED, device="cuda")
    data = make_synthetic_cls_dataset(VOCAB, SEARCH_SEQ, 2 * SEARCH_BATCH, seed=SEED + 13)
    profile = profile_statistics(batches=list(numpy_dataloader(data, SEARCH_BATCH)),
                                 model_fn=llama_for_sequence_classification, config=config,
                                 params=params)
    t_prof = time.perf_counter() - t0
    del params
    study, search, factory, secs = _cls_search(
        Search, SEARCH_LAYERS, COND_TRIALS, "cuda", SEARCH_SAMPLES, tmp / "cond",
        sc=_search_config(SEARCH_LAYERS, COND_TRIALS, COND_SPACE), stat_profile=profile)
    log(f"  conditional search: a stat profile of {len(profile)} entries over 2 batches in "
        f"{t_prof:.1f} s, then {COND_TRIALS} trials:")
    rows = _trial_rows(study, search.search_config["search_estimator"], secs)
    best = search.evaluate_best_trials(study, factory, "sst2")
    torch.cuda.synchronize()
    counts = {"search_conditional": all_launch_counts()}
    check(len(study.trials) == COND_TRIALS and 0 <= best["accuracy"] <= 1,
          f"conditional search: {best}")
    log(f"  evaluate_best_trials (frac widths from the profile): {best}")
    del search, study
    torch.cuda.empty_cache()
    return {"profile_entries": len(profile), "profile_seconds": t_prof, "trials": rows,
            "best": best}, counts


def _sst_examples(n):
    rng = np.random.default_rng(SEED + 14)
    words = ["good", "bad", "fine", "dull", "film", "plot", "great", "awful", "story", "cast"]
    return [{"sentence": " ".join(rng.choice(words, size=int(rng.integers(4, 12)))),
             "label": int(rng.integers(0, 2))} for _ in range(n)]


def _greedy_task():
    """A greedy task of GREEDY_WORDS gold words (register_task): a cache of
    a 32-multiple prompt and 16 new tokens, which the prob quantizer's
    block of 16 tiles, so that the packed cache takes the kernels."""
    from llm_mixed_q_torch.eval.prompting import register_task

    register_task("copy16", {"style": "greedy", "context": lambda ex: ex["context"],
                             "gold_text": lambda ex: ex["gold"], "dataset": (None, None, None)})
    rng = np.random.default_rng(SEED + 15)
    word = lambda: "w" + str(int(rng.integers(0, 999)))
    return [{"context": " ".join(word() for _ in range(int(rng.integers(8, 24)))),
             "gold": " " + " ".join(word() for _ in range(GREEDY_WORDS))}
            for _ in range(GREEDY_EXAMPLES)]


def search_prompting(tmp):
    """Part 4: ``SearchQuantisationForPromptingCLS``, 3 trials (TPE seed
    0) at 4 layers on 32 in-memory ``sst`` examples with a toy tokenizer,
    then its best trial's config (weights PTQ-prepared once, as
    ``cli_eval_prompting_cls`` serves them) on a greedy task through
    ``make_serving_generate_fn`` (its packed KV cache: K4), the counters
    read around that eval; the greedy ids at 1 layer held against the
    port on the CPU, teacher-forced. -> (results, launch counts)"""
    from llm_mixed_q_torch.eval.prompting import (
        eval_prompting_task, greedy_generate_ids, make_serving_generate_fn)
    from llm_mixed_q_torch.models import get_ptq_preparer
    from llm_mixed_q_torch.models.hf_loader import init_llama_params
    from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig
    from llm_mixed_q_torch.search import SearchQuantisationForPromptingCLS as Search
    from llm_mixed_q_torch.utils.trial_extractor import trial_to_quant_config

    tok = ToyTokenizer()
    examples = {"sst": _sst_examples(PROMPT_EXAMPLES)}
    greedy = _greedy_task()
    reset_all_launch_counts()
    mck = dict(SEARCH_WIDTHS, num_hidden_layers=SEARCH_LAYERS)
    params = init_llama_params(LlamaQuantizedConfig(**mck), seed=SEED, device="cuda")
    search = Search("llama", "llama-2-7b-widths", _search_config(SEARCH_LAYERS, PROMPT_TRIALS),
                    tmp / "prompting", params, tok, model_config_kwargs=mck)
    with _trial_clock() as clock:
        study = search.search_prompting(["sst"], SEARCH_SEQ, examples_by_task=examples)
    log(f"  prompting search, {PROMPT_TRIALS} trials on {PROMPT_EXAMPLES} sst examples:")
    rows = _trial_rows(study, search.search_config["search_estimator"], clock.seconds())
    best = search.evaluate_best_trials_prompting(study, ["sst"], examples_by_task=examples)
    torch.cuda.synchronize()
    counts = {"search_prompting": all_launch_counts()}
    log(f"  evaluate_best_trials_prompting: mean acc {best['mean_acc']:.4f} (trial "
        f"{best['best_trial_number']})")
    qc = trial_to_quant_config(study.trials[best["best_trial_number"]])
    out = {"trials": rows, "best": {k: v for k, v in best.items() if k != "results"}}
    for layers, device in ((SEARCH_LAYERS, "cuda"), (SEARCH_CPU_LAYERS, "cuda"),
                           (SEARCH_CPU_LAYERS, "cpu")):
        config = LlamaQuantizedConfig(**dict(mck, num_hidden_layers=layers),
                                      quant_config=search.q_config_parser(qc, layers,
                                                                          strict=False))
        p = params if layers == SEARCH_LAYERS else _on(init_llama_params(
            LlamaQuantizedConfig(**dict(mck, num_hidden_layers=layers)), seed=SEED,
            device="cpu"), device)
        # weights quantized once (PTQ), as the prompting eval CLI serves them
        p = get_ptq_preparer("llama")(p, config)
        gen = make_serving_generate_fn("llama", config, p, quantize_weights=False)
        if layers == SEARCH_LAYERS:
            reset_all_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eval_prompting_task(None, p, tok, "copy16", greedy, generate_fn=gen)
            torch.cuda.synchronize()
            counts["prompting_generate"] = all_launch_counts()
            launched = counts["prompting_generate"]["attn_decode_pos_major"]
            check(launched > 0 and counts["prompting_generate"]["attn_decode_packed_dense"] == 0,
                  f"the greedy eval's generate_fn did not decode through K4: "
                  f"{counts['prompting_generate']}")
            out["greedy"] = {"acc": res["acc"], "n": res["n"], "seconds":
                             time.perf_counter() - t0, "k4_launches": launched}
            log(f"  the best trial's config on {GREEDY_EXAMPLES} greedy examples of "
                f"{GREEDY_WORDS} gold words through make_serving_generate_fn: acc {res['acc']}, "
                f"{out['greedy']['seconds']:.2f} s, K4 launched {launched} times, the dense "
                f"route 0")
            continue
        ctxs = [greedy[i]["context"] for i in range(GREEDY_EXAMPLES)]
        ids = greedy_generate_ids(None, p, tok, ctxs, GREEDY_WORDS, generate_fn=gen)
        if device == "cuda":
            card_ids, card_params = ids, p
            continue
        check(np.array_equal(card_ids, ids) or _teacher_forced_ok(
            card_ids, p, config, tok, ctxs), "the card's greedy ids are neither the CPU's "
            "nor its argmax on their own history up to a near tie")
        out["greedy_card_vs_cpu_equal"] = bool(np.array_equal(card_ids, ids))
        log(f"  greedy ids at {SEARCH_CPU_LAYERS} layer(s), card vs CPU: "
            f"{'equal' if out['greedy_card_vs_cpu_equal'] else 'near ties only'}")
        del card_params, p
    del search, study, params
    torch.cuda.empty_cache()
    return out, counts


def _teacher_forced_ok(card_ids, cpu_params, config, tok, ctxs):
    """Each card token is the CPU's argmax on the card's history, or within
    TIE of its top logit (on PTQ-prepared weights, as the generate_fn)."""
    from llm_mixed_q_torch.models.llama import decode_step, prefill_into_cache
    from llm_mixed_q_torch.models.llama.serving import _cache_spec, _new_cache

    enc = [tok(c)["input_ids"] for c in ctxs]
    pad = (max(map(len, enc)) + 31) // 32 * 32
    ids = torch.zeros((len(enc), pad), dtype=torch.int64)
    mask = torch.zeros_like(ids)
    for i, e in enumerate(enc):
        ids[i, :len(e)], mask[i, :len(e)] = torch.as_tensor(e), 1
    n = card_ids.shape[1]
    cache = _new_cache(config, len(enc), pad + n, _cache_spec(config, None), "cpu")
    logits, lengths = prefill_into_cache(cpu_params, ids, mask, cache, config, False)
    tok_t = torch.as_tensor(card_ids, dtype=torch.int64)
    for t in range(n):
        if not _near_tie_ok(tok_t[:, t], logits):
            return False
        if t + 1 < n:
            logits = decode_step(cpu_params, tok_t[:, t:t + 1], cache, lengths + t, config,
                                 False)
    return True


def run_search(peaks, flush):
    """Phase 12: part 1 (fault 15: K4/K5 at new head_dims, the head_dim-80
    Llama); parts 2-4 (the searches and the prompting eval), each with its
    counters set to 0 before it and read after it. -> ({"search": results},
    kernel rows of part 1, launch counts by run)"""
    import tempfile

    t0 = time.perf_counter()
    log(f"phase 12, part 1: K4 and K5 at {', '.join(F15_SHAPES)} (faults 15 and 18):")
    head_dims = search_head_dims(peaks, flush)
    hd80, counts = search_head_dim_80()
    out = {"head_dim_80": hd80}
    parts = ((2, "the classification search", "classification", search_cls),
             (3, "the conditional search", "conditional", search_conditional),
             (4, "the prompting search and eval", "prompting", search_prompting))
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for n, what, key, fn in parts:
            t1 = time.perf_counter()
            log(f"phase 12, part {n}: {what} (Llama-2-7B widths, {SEARCH_LAYERS} layers):")
            out[key], part_counts = fn(Path(tmp))
            counts.update(part_counts)
            out[key]["seconds"] = time.perf_counter() - t1
            log(f"part {n} took {out[key]['seconds']:.1f} s")
    check_path_counts(counts)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 12 (search and prompting) took {out['seconds']:.1f} s")
    return {"search": out}, head_dims, counts


# phase 13 (--parallel-only): parallel/ on torch.distributed, two ranks on
# the one card over gloo (NCCL refuses two ranks on one device); the ranks
# are this script run with --parallel-rank, each loading the kernels this
# process built. Part 1: TP = 2 packed serving at Llama-2-7B widths cut to 2
# layers, batch 8, 16 prompt tokens and 16 new ones, at max_len 512 (16 kv
# heads a rank: a pos-major cache of 8192 lanes, K4, where the whole width's
# is head-major, K5) and 1024 (head-major on a rank too: K5); part 2: DP = 2
# and FSDP = 2 QAT at OPT-350M widths, 2 micro-steps on global batches of
# 8 x 128, under W4A4 (bfp_4bit.toml) and in float32; part 3: the five
# EMNLP drivers at --synthetic on the card, in this process; part 4:
# graft_entry.dryrun_multichip(2) on the ranks
P13_RANKS = 2
P13_LAYERS, P13_BATCH, P13_PROMPT, P13_NEW = 2, 8, 16, 16
P13_MAX_LENS = {512: "attn_decode_pos_major", 1024: "attn_decode_head_major"}
P13_FORMATS = {"subbyte_t": ("bfp_matmul_subbyte_t",),
               "int8": ("bfp_matmul_int8", "actq_split")}
P13_QAT_BATCH, P13_QAT_STEPS = 8, 2
# part 2 holds W4A4 steps to one process on the ranks' slices (the ranks'
# GEMM shapes): a sum in another order at another M flips a 3-bit rounding
# now and then, and 24 random layers carry the flips to the loss. float32
# has no such rounding, so its gradient is held to one process's on the
# global batch too (a gradient, not a step: Adam's first update is lr times
# the gradient's sign, which rounding noise flips where the gradient is
# ~0), as a whole: a ReLU whose input is ~0 may pass its gradient on one
# side and not the other, and the pooled token carries most of a unit's
# gradient, so a leaf's largest element may move by ~1/8, and the whole
# gradient by 3.0e-3 (L2; one process's slices against its global batch,
# H100 80GB HBM3 at 700 W): held within 1e-2. The witness: the
# first forward of a global batch against its slices', no step between,
# by (layers, quant config)
P13_WITNESS = {"float32_24": (24, "bypass"), "w4a4_24": (24, "bfp_4bit"),
               "w4a4_2": (2, "bfp_4bit")}
P13_TIMEOUT = 600  # seconds for both ranks
# each rank's runs: the TP generates launch their tree's matmul and their
# cache's attention kernel; QAT and the drivers (the fake-quant forward and
# its backward, search) no Hopper kernel
PATHS.update({f"tp_{fmt}_{n}_rank{r}": names + (attn,) for r in range(P13_RANKS)
              for fmt, names in P13_FORMATS.items() for n, attn in P13_MAX_LENS.items()})
PATHS.update({f"qat_{arm}_{mode}_rank{r}": () for r in range(P13_RANKS)
              for arm in ("w4a4", "float32") for mode in ("dp", "fsdp")})
PATHS["emnlp_drivers"] = ()
# part 4: the fake-quant QAT step and the float32 cache of dryrun_multichip
PATHS.update({f"graft_dryrun_rank{r}": () for r in range(P13_RANKS)})


def _p13_serving(mesh, rank):
    """Part 1 on this rank: for each packed tree, ``generate`` on the rank's
    local tree at both cache lengths (counters set to 0 before each and
    read after), then one decode step's logits after a prefill; rank 0 also
    runs the same on the whole tree in this one process."""
    from llm_mixed_q_torch.models.hf_loader import init_llama_params
    from llm_mixed_q_torch.models.llama import (LlamaQuantizedConfig, decode_step, generate,
                                                prefill_into_cache)
    from llm_mixed_q_torch.models.llama.serving import _cache_spec, _new_cache
    from llm_mixed_q_torch.parallel import shard_params, tp

    config = LlamaQuantizedConfig(vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=INTER,
                                  num_hidden_layers=P13_LAYERS, num_attention_heads=HEADS,
                                  max_position_embeddings=2048, quant_config=_toml("bfp_6bit"))
    ids = torch.as_tensor(np.random.default_rng(SEED + 13).integers(
        2, VOCAB, (P13_BATCH, P13_PROMPT)), device="cuda")
    mask = torch.ones_like(ids)

    def run(params, max_len):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = generate(params, config, ids, mask, max_new_tokens=P13_NEW, max_len=max_len,
                          device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        cache = _new_cache(config, P13_BATCH, max_len, _cache_spec(config, None), "cuda")
        logits, lengths = prefill_into_cache(params, ids, mask, cache, config)
        step = decode_step(params, logits.argmax(-1)[:, None], cache, lengths, config)
        return {"tokens": np.asarray(tokens), "step": step.float().cpu().numpy(),
                "seconds": secs, "pos_major": cache.pos_major, "kv_heads": cache.nkv}

    def columns(full, local):
        """Whether rank 0's columns of the fused q/k/v node (its kernel at
        N = 6144 against 12288) and of lm_head (the float32 GEMM at 16000
        columns against 32000) are the whole node's bits."""
        from llm_mixed_q_torch.models.llama.modeling import _node_cfg
        from llm_mixed_q_torch.ops.linear import quantized_linear

        gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
        x = torch.randn((P13_BATCH, HIDDEN), generator=gen, device="cuda")
        cfg = _node_cfg(config.quant_config, 0, "self_attn", "q_proj")
        nodes = [t["layers"][0]["self_attn"]["qkv_proj"] for t in (full, local)]
        y_full, y_local = (quantized_linear(x, n["weight"], None, cfg, True) for n in nodes)
        starts = np.cumsum([0, *nodes[0]["splits"]])[:-1]
        want = torch.cat([y_full[:, a:a + n] for a, n in zip(starts, nodes[1]["splits"])], 1)
        h = x.to(torch.bfloat16).float()
        lm = [h @ t["lm_head"]["weight"].float().t() for t in (full, local)]
        return {"qkv_bit_equal": bool(torch.equal(y_local, want)),
                "qkv_max_gap": float((y_local - want).abs().max() / want.abs().max()),
                "lm_head_bit_equal": bool(torch.equal(lm[1], lm[0][:, :lm[1].shape[1]])),
                "lm_head_max_gap": float((lm[1] - lm[0][:, :lm[1].shape[1]]).abs().max()
                                         / lm[0].abs().max())}

    out, counts = {}, {}
    for fmt in P13_FORMATS:
        full = init_llama_params(config, seed=SEED, device="cuda",
                                 pack=dict(subbyte=fmt == "subbyte_t", bf16_embed=True))
        local = shard_params(full, mesh, config=config)
        if rank == 0:
            out[f"columns_{fmt}"] = columns(full, local)
        for max_len in P13_MAX_LENS:
            path = f"tp_{fmt}_{max_len}_rank{rank}"
            reset_all_launch_counts()
            with tp.spmd(mesh):
                out[path] = run(local, max_len)
            counts[path] = all_launch_counts()
            if rank == 0:
                out[f"one_{fmt}_{max_len}"] = run(full, max_len)
        del full, local
        torch.cuda.empty_cache()
    return out, counts


def _p13_batch_witness(params, batch):
    """Rank 0, one process, no step: the first forward of the global batch
    against the forwards of its ``P13_RANKS`` slices, for each arm of
    ``P13_WITNESS`` (the first layers of the same weights). A row's
    arithmetic is the same in both (the quantizers' blocks lie within a
    row, and the zero-block fill changes no output), so only the GEMMs'
    sum order at another M differs. -> {arm: gaps}"""
    from llm_mixed_q_torch.models import get_model_fn

    model = get_model_fn("opt", "cls")
    ids, mask, labels = (torch.as_tensor(batch[k], device="cuda")
                         for k in ("input_ids", "attention_mask", "labels"))
    m = P13_QAT_BATCH // P13_RANKS
    out = {}
    for name, (layers, stem) in P13_WITNESS.items():
        config = _qat_config("opt", layers, stem)
        tree = {**params, "layers": params["layers"][:layers]}
        with torch.no_grad():
            whole = model(tree, ids, mask, labels=labels, config=config, quantize_weights=True)
            parts = [model(tree, ids[i:i + m], mask[i:i + m], labels=labels[i:i + m],
                           config=config, quantize_weights=True)
                     for i in range(0, P13_QAT_BATCH, m)]
        logits = torch.cat([q["logits"] for q in parts])
        loss, loss_slices = float(whole["loss"]), sum(float(q["loss"]) for q in parts) / len(parts)
        out[name] = {"loss_whole": loss, "loss_slices": loss_slices,
                     "loss_gap_rel": abs(loss - loss_slices) / loss,
                     "logits_gap": float((whole["logits"] - logits).abs().max()
                                         / whole["logits"].abs().max()),
                     "labels_differ": int((whole["logits"].argmax(-1)
                                           != logits.argmax(-1)).sum())}
    return out


def _p13_qat(mesh, rank):
    """Part 2 on this rank: DP and FSDP runs of the rank's slice of each
    global batch: under W4A4 the QAT micro-steps, the losses and the whole
    parameters after them; in float32 one micro-step whose optimizer does
    not update, its loss and the whole gradient. Rank 0 also runs, in this
    one process, the references: each global batch taken as the ranks'
    slices accumulated ("slices": the ranks' GEMM shapes, DP's sums in one
    process; ``MultiSteps`` over the slices under W4A4), and in float32
    the micro-step on the global batch ("global"); and
    ``_p13_batch_witness``."""
    from types import SimpleNamespace

    from llm_mixed_q_torch.datasets import make_synthetic_cls_dataset
    from llm_mixed_q_torch.models.hf_loader import init_opt_params
    from llm_mixed_q_torch.parallel import global_batch
    from llm_mixed_q_torch.train.qat import (MeshLayout, MultiSteps, _to_device, leaves_of,
                                             make_adamw, make_qat_train_step, named_leaves,
                                             shard_for_training, whole_params)

    w4a4, float32 = (_qat_config("opt", OPT350["num_hidden_layers"], stem)
                     for stem in ("bfp_4bit", "bypass"))
    params = init_opt_params(w4a4, task="cls", seed=SEED, device="cuda")
    data = make_synthetic_cls_dataset(OPT350["vocab_size"], QAT_SEQ,
                                      P13_QAT_BATCH * P13_QAT_STEPS, seed=SEED + 13)
    batches = [{k: v[i * P13_QAT_BATCH:(i + 1) * P13_QAT_BATCH] for k, v in data.items()}
               for i in range(P13_QAT_STEPS)]
    flat = lambda tree: {".".join(map(str, p)): t.detach() for p, t in named_leaves(tree)}

    def run(config, mesh_=None, fsdp=False, slices=1, update=True):
        """-> (losses, whole parameters, or without ``update`` the mean
        gradient of the slices, seconds)"""
        tree = shard_for_training(params, mesh_, fsdp, config)
        opt = (MultiSteps(*make_adamw(leaves_of(tree), QAT_LR, 0.0), every_k=slices) if update
               else SimpleNamespace(step=lambda: None))
        step = make_qat_train_step("opt", "cls", config, opt, mesh_, fsdp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for b in batches if update else batches[:1]:
            if mesh_ is not None:
                b, _ = global_batch(mesh_, b)
            m = P13_QAT_BATCH // slices
            parts = [{k: v[i * m:(i + 1) * m] for k, v in b.items()} for i in range(slices)]
            losses.append(sum(float(step(tree, _to_device(p, "cuda"))) for p in parts) / slices)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        layout = None if mesh_ is None else MeshLayout(mesh_, fsdp)
        if update:
            return losses, flat(tree if layout is None else whole_params(layout, leaves_of(tree))), secs
        grads = {}
        for p, t in named_leaves(leaves_of(tree)):  # the same leaves on every rank
            if t.grad is not None:
                grads[".".join(map(str, p))] = (
                    t.grad / slices if layout is None else layout.full(t.grad, layout.spec(p, t)))
        return losses, grads, secs

    def step_gaps(after, ref, start):
        """An attention key's bias has a gradient of 0 in exact arithmetic
        (``_grad_gaps``): its change is each side's rounding noise, held by
        the lr bound only, and reported over the largest leaf change."""
        change = {k: (ref[k] - start[k]).abs().max() for k in ref}
        noise = [k for k in ref if k.endswith("k_proj.bias")]
        return {"max_param_gap_over_lr": max(float((after[k] - ref[k]).abs().max())
                                             for k in ref) / QAT_LR,
                "beyond_1e_2_of_change": sum(int(((after[k] - ref[k]).abs() > 1e-2 * change[k])
                                                 .sum()) for k in ref if k not in noise),
                "elements": sum(ref[k].numel() for k in ref if k not in noise),
                "key_bias_change": max(float(change[k]) for k in noise)
                / max(float(c) for c in change.values())}

    def grad_gaps(got, want):
        """Each leaf's max|got - want| over its max|want|, the leaves beyond
        1e-4 of it, and the whole gradient's |got - want| over |want| (L2);
        the key biases' gradients (rounding noise: ``_grad_gaps``) apart,
        over the largest leaf's max on both sides."""
        top = max(float(w.abs().max()) for w in want.values())
        noise = [k for k in want if k.endswith("k_proj.bias")]
        keys = [k for k in want if k in got and k not in noise]
        gaps = {k: float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30)
                for k in keys}
        worst = max(gaps, key=gaps.get)
        diff2 = sum(float((got[k] - want[k]).double().square().sum()) for k in keys)
        norm2 = sum(float(want[k].double().square().sum()) for k in keys)
        return {"same_leaves": sorted(got) == sorted(want), "leaves": len(want),
                "grad_gap_of_leaf_max": gaps[worst], "worst_leaf": worst,
                "leaves_beyond_1e_4": sum(g > 1e-4 for g in gaps.values()),
                "grad_rel_l2": (diff2 / norm2) ** 0.5,
                "key_bias_noise": max(max(float(got[k].abs().max()), float(want[k].abs().max()))
                                      for k in noise) / top}

    out, counts = {}, {}
    start = flat(params)
    if rank == 0:
        out["witness"] = _p13_batch_witness(params, batches[0])
        refs = {"w4a4": {"slices": run(w4a4, slices=P13_RANKS)},
                "float32": {"slices": run(float32, slices=P13_RANKS, update=False),
                            "global": run(float32, update=False)}}
        out["float32_slices_vs_global"] = grad_gaps(refs["float32"]["slices"][1],
                                                    refs["float32"]["global"][1])
    for arm, config in (("w4a4", w4a4), ("float32", float32)):
        for fsdp in (False, True):
            path = f"qat_{arm}_{'fsdp' if fsdp else 'dp'}_rank{rank}"
            reset_all_launch_counts()
            losses, got, secs = run(config, mesh, fsdp, update=arm == "w4a4")
            counts[path] = all_launch_counts()
            out[path] = {"losses": losses, "seconds": secs}
            if rank == 0:
                gaps = (lambda ref: step_gaps(got, ref, start)) if arm == "w4a4" else (
                    lambda ref: grad_gaps(got, ref))
                out[path]["refs"] = {name: {"losses": losses_, "seconds": secs_, **gaps(ref)}
                                     for name, (losses_, ref, secs_) in refs[arm].items()}
            del got
            torch.cuda.empty_cache()
    return out, counts


def _p13_dryrun(rank):
    """Part 4 on this rank: ``graft_entry.dryrun_multichip(2)`` (a (1, 1, 2)
    hybrid mesh: one QAT step, then a TP-sharded prefill and decode step on
    a float32 cache; it asserts a finite loss and finite logits), its
    launches counted from 0. -> (seconds, {path: launch counts})"""
    from llm_mixed_q_torch.graft_entry import dryrun_multichip

    reset_all_launch_counts()
    t0 = time.perf_counter()
    dryrun_multichip(P13_RANKS)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, {f"graft_dryrun_rank{rank}": all_launch_counts()}


def parallel_rank(rank: int, port: int, outdir: Path):
    """One rank of phase 13 (run by ``run_parallel`` as ``chip_smoke.py
    --parallel-rank <rank> <port> <dir>``): its results and launch counts
    to ``<dir>/rank<r>.pkl``, or the error that stopped it."""
    import pickle
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    result = {}
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=P13_RANKS, timeout=timedelta(seconds=P13_TIMEOUT))
        from llm_mixed_q_torch.kernels import _cuda
        from llm_mixed_q_torch.parallel import make_mesh

        _cuda.lib("kernels")  # built by the parent: the same sources, the same library
        serving, counts = _p13_serving(make_mesh(data=1, model=P13_RANKS, device_type="cuda"), rank)
        dist.barrier()
        qat, qat_counts = _p13_qat(make_mesh(data=P13_RANKS, model=1, device_type="cuda"), rank)
        dist.barrier()
        dryrun_seconds, dryrun_counts = _p13_dryrun(rank)
        result = {"serving": serving, "qat": qat, "dryrun_seconds": dryrun_seconds,
                  "counts": {**counts, **qat_counts, **dryrun_counts}}
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        result = {"error": traceback.format_exc()}
    with open(outdir / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    sys.exit(1 if "error" in result else 0)


def _p13_drivers(tmp: Path):
    """Part 3: the five EMNLP drivers of the port at --synthetic on the
    card, in this process; their artifacts present and their numbers
    finite. -> {driver: seconds}"""
    import csv
    import importlib

    runs = {"section_1_variance": ["--model_arch", "llama"],
            "section_4_2_perplexity": [], "section_4_2_downstream": [],
            "section_4_3_qat": [], "section_4_4_search": []}
    artifacts = {"section_1_variance": ("variance_vs_depth.json", "variance_vs_depth.csv"),
                 "section_4_2_perplexity": ("perplexity_summary.csv", "ppl_w6a6_bfp.json"),
                 "section_4_2_downstream": ("downstream_summary.csv", "downstream_w4a4_bfp.json"),
                 "section_4_3_qat": ("qat_history.json",),
                 "section_4_4_search": ("search_summary.json", "results.csv", "study.pkl")}
    secs = {}
    for name, extra in runs.items():
        out = tmp / name
        t0 = time.perf_counter()
        importlib.import_module(f"llm_mixed_q_torch.experiments.emnlp.{name}").main(
            ["--synthetic", "--device", "cuda", "--save_dir", str(out), *extra])
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        for a in artifacts[name]:
            check((out / a).is_file(), f"{name} wrote no {a}")
            numbers = []
            if a.endswith(".csv"):
                rows = list(csv.reader(open(out / a)))[1:]
                numbers = [float(x) for r in rows for x in r[1:]]
            elif a.endswith(".json"):
                text = (out / a).read_text()
                check("NaN" not in text and "Infinity" not in text, f"{name}: {a} not finite")
            check(all(math.isfinite(x) for x in numbers), f"{name}: {a} not finite")
        log(f"  {name}: {secs[name]:.1f} s, artifacts {', '.join(artifacts[name])}")
    return secs


def run_parallel(smi):
    """Phase 13: two ranks on the one card (``parallel_rank``), then the
    drivers here. -> ({"parallel": results}, launch counts by run)"""
    import pickle
    import socket
    import tempfile

    t0 = time.perf_counter()
    log(f"phase 13: parallel/ over gloo, {P13_RANKS} ranks sharing the one card ({smi}); "
        f"the times below are no scaling figures")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        # the ranks are one host: each holds the host's (global) batches
        env = {**os.environ, "LOCAL_WORLD_SIZE": str(P13_RANKS)}
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--parallel-rank", str(r), str(port), str(tmp)], cwd=ROOT,
                                  env=env)
                 for r in range(P13_RANKS)]
        try:
            for p in procs:
                p.wait(timeout=P13_TIMEOUT)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = []
        for r in range(P13_RANKS):
            path = tmp / f"rank{r}.pkl"
            check(path.is_file(), f"phase 13: rank {r} wrote no results (exit "
                                  f"{procs[r].returncode})")
            with open(path, "rb") as f:
                ranks.append(pickle.load(f))
            check("error" not in ranks[-1], f"phase 13: rank {r} failed:\n"
                                            f"{ranks[-1].get('error')}")
        t1 = time.perf_counter()
        log(f"phase 13, parts 1 and 2 (both ranks, with their start) took {t1 - t0:.1f} s")
        out = {"serving": {}, "qat": {}}
        counts = {}
        for rank in ranks:
            counts.update(rank["counts"])
        for fmt in P13_FORMATS:
            for max_len, attn in P13_MAX_LENS.items():
                one = ranks[0]["serving"][f"one_{fmt}_{max_len}"]
                row = {"one_process_seconds": one["seconds"]}
                for r, rank in enumerate(ranks):
                    got = rank["serving"][f"tp_{fmt}_{max_len}_rank{r}"]
                    check(np.array_equal(got["tokens"], one["tokens"]),
                          f"TP {fmt} max_len {max_len}: rank {r}'s tokens differ from the "
                          f"one-process run")
                    gap = float(np.abs(got["step"] - one["step"]).max()
                                / np.abs(one["step"]).max())
                    check(gap <= QUANT_GATE, f"TP {fmt} max_len {max_len}: logits gap {gap}")
                    c = counts[f"tp_{fmt}_{max_len}_rank{r}"]
                    row[f"rank{r}"] = {"seconds": got["seconds"], "logits_gap": gap,
                                       "bit_equal": gap == 0.0, "pos_major": got["pos_major"],
                                       "kv_heads": got["kv_heads"],
                                       "launches": {k: v for k, v in c.items() if v}}
                row["columns"] = ranks[0]["serving"][f"columns_{fmt}"]
                out["serving"][f"{fmt}_{max_len}"] = row
                log(f"  TP=2 {fmt}, max_len {max_len}: tokens equal to the one-process run on "
                    f"both ranks; logits gap {row['rank0']['logits_gap']:.3e} / "
                    f"{row['rank1']['logits_gap']:.3e} of max|logit|; local cache "
                    f"{'pos-major' if row['rank0']['pos_major'] else 'head-major'} "
                    f"({row['rank0']['kv_heads']} kv heads; the one-process run "
                    f"{'pos-major' if one['pos_major'] else 'head-major'}); generate "
                    f"{row['rank0']['seconds']:.2f} / {row['rank1']['seconds']:.2f} s against "
                    f"{one['seconds']:.2f} s alone; launches rank 0 {row['rank0']['launches']}, "
                    f"rank 1 {row['rank1']['launches']}; rank 0's columns against the whole "
                    f"node's: {row['columns']}")
        witness = ranks[0]["qat"]["witness"]
        log(f"  one process, the first forward of the global batch of {P13_QAT_BATCH} against "
            f"its {P13_RANKS} slices (OPT-350M widths): {witness}")
        # float32 at 24 layers: only the sum order differs; W4A4 at 2 layers:
        # phase 8's gate for a float32 sum in another order
        check(witness["float32_24"]["logits_gap"] <= 1e-5,
              f"float32: the global batch's logits against its slices' {witness['float32_24']}")
        check(witness["w4a4_2"]["loss_gap_rel"] <= 2e-3,
              f"W4A4, 2 layers: the global batch's loss against its slices' {witness['w4a4_2']}")
        out["qat"]["witness"] = witness
        one = ranks[0]["qat"]["float32_slices_vs_global"]
        log(f"  one process, float32, the gradient of the global batch's slices against the "
            f"global batch's: {one}")
        out["qat"]["float32_slices_vs_global"] = one
        names = {"slices": "the ranks' slices", "global": "the global batch"}
        for arm in ("w4a4", "float32"):
            for mode in ("dp", "fsdp"):
                key = f"qat_{arm}_{mode}"
                got = ranks[0]["qat"][f"{key}_rank0"]
                losses = [rank["qat"][f"{key}_rank{r}"]["losses"] for r, rank in enumerate(ranks)]
                check(losses[0] == losses[1], f"{key}: the ranks' losses differ: {losses}")
                held = []
                for name, ref in got["refs"].items():
                    check(np.allclose(losses[0], ref["losses"], rtol=1e-5, atol=0),
                          f"{key}: losses {losses[0]} against one process on {names[name]} "
                          f"{ref['losses']}")
                    if arm == "w4a4":
                        # Adam moves an element by at most ~lr an update, so a
                        # gradient near 0 summed in another order may move it
                        # anywhere within that
                        ok = (ref["max_param_gap_over_lr"] <= P13_QAT_STEPS * (1 + 1e-3)
                              and ref["beyond_1e_2_of_change"] <= ref["elements"] // 1000)
                        held.append(
                            f"on {names[name]} {ref['losses']}: parameters within "
                            f"{ref['max_param_gap_over_lr']:.3f} lr, "
                            f"{ref['beyond_1e_2_of_change']} of {ref['elements']} elements "
                            f"beyond 1e-2 of their leaf's max change, the key biases' change "
                            f"(rounding noise) {ref['key_bias_change']:.3e} of the largest")
                    else:
                        # on the slices (the same GEMM shapes) phase 8's gate of a
                        # float32 gradient, each leaf within 1e-4 of its max; on
                        # the global batch the whole within 1e-2 (L2), past the
                        # ReLU kinks above
                        ok = ref["same_leaves"] and ref["key_bias_noise"] < 1e-5 and (
                            ref["grad_gap_of_leaf_max"] <= 1e-4 if name == "slices"
                            else ref["grad_rel_l2"] <= 1e-2)
                        held.append(
                            f"on {names[name]} {ref['losses']}: the gradient within "
                            f"{ref['grad_rel_l2']:.3e} (L2), each leaf within "
                            f"{ref['grad_gap_of_leaf_max']:.3e} of its max ({ref['worst_leaf']}; "
                            f"{ref['leaves_beyond_1e_4']} of {ref['leaves']} leaves beyond "
                            f"1e-4), the key biases' (rounding noise) "
                            f"{ref['key_bias_noise']:.3e} of the largest leaf's max")
                    check(ok, f"{key}: against one process on {names[name]}: {ref}")
                out["qat"][f"{arm}_{mode}"] = {
                    **got, "losses": losses[0],
                    "rank1_seconds": ranks[1]["qat"][f"{key}_rank1"]["seconds"]}
                what = (f"{P13_QAT_STEPS} micro-steps" if arm == "w4a4"
                        else "1 micro-step with no update")
                alone = min(ref["seconds"] for ref in got["refs"].values())
                log(f"  {mode.upper()}=2 QAT, OPT-350M widths, {arm}, {what} on {P13_QAT_BATCH} x "
                    f"{QAT_SEQ}: losses {losses[0]}, the same on both ranks; one process "
                    f"{'; '.join(held)}; {got['seconds']:.2f} s on rank 0 against "
                    f"{alone:.2f} s alone")
        out["dryrun_multichip_seconds"] = [rank["dryrun_seconds"] for rank in ranks]
        log(f"  graft_entry.dryrun_multichip({P13_RANKS}) on both ranks (model = 2): finite "
            f"loss and logits, {ranks[0]['dryrun_seconds']:.2f} / "
            f"{ranks[1]['dryrun_seconds']:.2f} s")
        log("phase 13, part 3: the five EMNLP drivers at --synthetic on the card:")
        reset_all_launch_counts()
        out["drivers_seconds"] = _p13_drivers(tmp)
        counts["emnlp_drivers"] = all_launch_counts()
    check_path_counts(counts)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 13 (parallel and the drivers) took {out['seconds']:.1f} s ({smi})")
    return {"parallel": out}, counts


# phase 14 (--scripts-only): the repo's root scripts on the port. (a)
# graft_entry.entry()'s forward (the fake-quant flagship forward) on the card
# against the same forward on the CPU; (b) the quality harness's Llama arm
# (llm_mixed_q_torch.quality: train_fp32 at a few steps, then ppl under fp32,
# calibrated W8A8, W6A6, W4A4 and W6A6 packed; the packed eval's 512 rows a
# batch take the unpack + matmul route); (c) its 7B arm's teacher-forced
# per-layer parity at layers 0, 15 and 31 (random 7B-width layers drawn on
# the card), the packed layers' linears on K2 with actq_split at 2 x 64 rows
SCRIPTS_STEPS = 10  # the harness's training steps here (its default is 300)
SCRIPTS_ENTRY_TOL = 1e-4  # (a): of max|logit|, float32 sums in another order
SCRIPTS_PACKED_REL = 1e-4  # (b): W6A6 packed against W6A6 fake-quant ppl, relative
PATHS.update({"graft_entry": (), "quality_llama": (),
              "quality_7b_per_layer": ("bfp_matmul_int8", "actq_split")})


def scripts_entry():
    """(a) -> {"gap_of_max_logit", "seconds"}"""
    from llm_mixed_q_torch.graft_entry import entry
    from llm_mixed_q_torch.models.hf_loader import tree_map_tensors

    t0 = time.perf_counter()
    fn, (params, ids, mask) = entry()
    got = fn(params, ids, mask).cpu()
    want = fn(tree_map_tensors(lambda t: t.cpu(), params), ids.cpu(), mask.cpu())
    gap = float((got - want).abs().max() / want.abs().max())
    check(got.shape == (2, 64, 256) and bool(torch.isfinite(got).all()),
          f"entry(): logits {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
    check(gap <= SCRIPTS_ENTRY_TOL, f"entry(): card against CPU {gap} of max|logit|")
    out = {"gap_of_max_logit": gap, "seconds": time.perf_counter() - t0}
    log(f"  (a) entry(): logits {tuple(got.shape)} on the card within {gap:.3e} of max|logit| "
        f"of the CPU's, {out['seconds']:.1f} s")
    return out


def scripts_quality_llama():
    """(b) -> {"configs", "train_loss", "packed_vs_fake_rel", "seconds"}"""
    from llm_mixed_q_torch import quality
    from llm_mixed_q_torch.models.hf_loader import init_llama_params

    t0 = time.perf_counter()
    corpus = quality.synthetic_corpus(400 * quality.SEQ, seed=0)
    train, test = corpus[: 320 * quality.SEQ], corpus[320 * quality.SEQ:]
    cfg = quality.build_model("fp32")
    params = init_llama_params(cfg, task="lm", seed=SEED, device="cuda")
    params, loss = quality.train_fp32(params, cfg, train, SCRIPTS_STEPS)
    configs, _ = quality._llama_configs(params, cfg, train, test)
    numbers = [v for row in configs.values() for v in row.values() if isinstance(v, float)]
    check(math.isfinite(loss) and all(map(math.isfinite, numbers)),
          f"quality harness: not finite: loss {loss}, {configs}")
    rel = abs(configs["w6a6_bfp_packed"]["delta_vs_fake_quant"]) / configs["w6a6_bfp"]["ppl"]
    check(rel <= SCRIPTS_PACKED_REL, f"quality harness: W6A6 packed {rel} off fake-quant")
    out = {"configs": configs, "train_loss": loss, "packed_vs_fake_rel": rel,
           "seconds": time.perf_counter() - t0}
    log(f"  (b) the quality harness's Llama arm, {SCRIPTS_STEPS} steps: loss {loss:.4f}, ppl "
        + ", ".join(f"{k} {v['ppl']}" for k, v in configs.items())
        + f"; W6A6 packed {rel:.3e} off fake-quant (relative), {out['seconds']:.1f} s")
    return out


def scripts_seven_b_per_layer():
    """(c) -> ({"layer_<i>": pairs, "seconds"}, launch counts of the card part)"""
    from llm_mixed_q_torch import quality
    from llm_mixed_q_torch.models.hf_loader import init_llama_params, tree_map_tensors
    from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig

    t0 = time.perf_counter()
    qc = quality.quant_cfg("w6a6_bfp")
    cfg = LlamaQuantizedConfig(**quality._SEVEN_B, quant_config=qc)
    one = LlamaQuantizedConfig(**{**quality._SEVEN_B, "num_hidden_layers": 1}, quant_config=qc)
    layers = {li: tree_map_tensors(lambda t: t.cpu(), init_llama_params(
        one, seed=SEED + li, device="cuda")["layers"][0]) for li in quality._SEVEN_B_LAYERS}
    reset_all_launch_counts()
    per_layer = quality._seven_b_per_layer(layers, cfg, torch.device("cuda"))
    torch.cuda.synchronize()
    counts = all_launch_counts()
    for name, row in per_layer.items():
        pair = row["packed_vs_chip_fake"]
        check(all(math.isfinite(v) for r in row.values() if isinstance(r, dict)
                  for v in r.values()), f"7B per-layer parity, {name}: not finite {row}")
        check(pair["max_abs_over_ref_rms"] <= QUANT_GATE,
              f"7B per-layer parity, {name}: packed against fake-quant on the card {pair}")
        log(f"  (c) 7B widths, {name}: packed_vs_chip_fake {pair}, chip_fake_vs_cpu_oracle "
            f"{row['chip_fake_vs_cpu_oracle']}")
    per_layer["seconds"] = time.perf_counter() - t0
    return per_layer, counts


def run_scripts(smi):
    """Phase 14, each part between a reset of the launch counters and a
    reading. -> ({"scripts": results}, launch counts by run)"""
    t0 = time.perf_counter()
    log(f"phase 14: the root scripts on the port ({smi})")
    out, counts = {}, {}
    reset_all_launch_counts()
    out["entry"] = scripts_entry()
    counts["graft_entry"] = all_launch_counts()
    reset_all_launch_counts()
    out["quality_llama"] = scripts_quality_llama()
    counts["quality_llama"] = all_launch_counts()
    out["seven_b_per_layer"], counts["quality_7b_per_layer"] = scripts_seven_b_per_layer()
    check_path_counts(counts)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 14 (the root scripts) took {out['seconds']:.1f} s ({smi})")
    return {"scripts": out}, counts


def kernel_entries(rows, path_counts):
    """The entries of the ``{"kernels": ...}`` line. launches: the sum over
    the runs that take the kernel (serving paths for K1-K5, the probe
    entry points for the probes), each counted from 0 around its own run."""
    matmul_cu = "llm_mixed_q_torch/csrc/dequant_matmul.cu"
    attention_cu = "llm_mixed_q_torch/csrc/attention_decode.cu"
    sources = {"bfp_matmul_subbyte_t": (matmul_cu, "llm_mixed_q_tpu/kernels/dequant_matmul.py:349"),
               "bfp_matmul_int8": (matmul_cu, "llm_mixed_q_tpu/kernels/dequant_matmul.py:118"),
               # the data_in quantizer of _dequant_matmul_kernel, once a call
               "actq_split": (matmul_cu, "llm_mixed_q_tpu/kernels/dequant_matmul.py:63"),
               "bfp_matmul_subbyte": (matmul_cu, "llm_mixed_q_tpu/kernels/dequant_matmul.py:221"),
               "attn_decode_pos_major": (attention_cu,
                                         "llm_mixed_q_tpu/kernels/attention_decode.py:326"),
               "attn_decode_head_major": (attention_cu,
                                          "llm_mixed_q_tpu/kernels/attention_decode.py:430"),
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
            "opt_mlp_ms", "opt_mlp_prefill_ms", "variants", "beside_ms", "aliases", "sass_ldg",
            "split_ms", "matmul_alone_ms", "pdl_race",
            "k2_vs_c32_k512_err", "k3_vs_c32_t1_err", "k4_vs_anchor_err", "v2_full_vs_anchor_err",
            "v3_masks_vs_anchor_err", "kernels_ms", "shapes", "bert_shapes", "head_dims")
            if key in r}
        if kname in PROBE_ALSO_REPLACES:
            extra["also_replaces"] = PROBE_ALSO_REPLACES[kname]
        kernels.append(dict(name=kname, route="cuda", source=src, replaces=replaces,
                            path=", ".join(p for p, c in by_path.items() if c), launches=launches,
                            launches_by_path=by_path, max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"], **extra))
    return kernels

def main(only=None):
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
    if only == "ppl":
        ppl, _ = run_ppl()
        print(json.dumps(ppl), flush=True)
        return
    if only == "qat":
        qat, _ = run_qat()
        print(json.dumps(qat), flush=True)
        return
    if only == "stats":
        _cuda.lib("kernels")
        stats, _ = run_stats()
        print(json.dumps(stats), flush=True)
        return
    if only == "parallel":
        _cuda.lib("kernels")
        parallel, _ = run_parallel(smi)
        print(json.dumps(parallel), flush=True)
        return
    if only == "scripts":
        _cuda.lib("kernels")
        scripts, _ = run_scripts(smi)
        print(json.dumps(scripts), flush=True)
        return
    if only == "search":
        _cuda.lib("kernels")
        flush_buf = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
        search, head_dims, _ = run_search(peaks, lambda: flush_buf.zero_())
        log(json.dumps({"head_dims": head_dims}))
        print(json.dumps(search), flush=True)
        return
    if only == "tail":
        _cuda.lib("kernels")
        flush_buf = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
        tail, _ = run_tail(peaks, lambda: flush_buf.zero_())
        print(json.dumps(tail), flush=True)
        return

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
            **count_sass(libs["kernels"], "int8_kernel", "HMMA"),
            **count_sass(libs["kernels"], "subbyte_kernel", "HMMA"),
            **count_sass(libs["probes"], "probe_t_kernel", "HMMA")}
    log(f"HMMA instructions in K1's, K2's, K3's and P8's SASS: {hmma}")

    flush_buf = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    flush = lambda: flush_buf.zero_()
    if only == "k1":
        # K1's times alone, for comparing two versions of it in one call
        log(f"K1 vs its plain version at 7B decode shapes, batch {BATCH} and {PREFILL_M} rows:")
        log(json.dumps(check_matmul_kernels(peaks, flush, only="bfp_matmul_subbyte_t")))
        return
    check(all(hmma.values()), f"K1, K2, K3 or P8 does not run on the tensor cores: {hmma}")
    if only == "k2":
        log(f"K2 and actq_split vs their plain versions at 7B decode shapes, batch {BATCH} "
            f"and {PREFILL_M} rows:")
        log(json.dumps({"bfp_matmul_int8": check_matmul_kernels(peaks, flush,
                                                                only="bfp_matmul_int8"),
                        "actq_split": check_actq_split(peaks, flush),
                        "pdl_race": check_pdl_race()}))
        return
    if only == "k3":
        log(f"K3 (with actq_split) vs its plain version at 7B decode shapes and OPT fc1/fc2, "
            f"batch {BATCH} and {PREFILL_M} rows:")
        log(json.dumps(check_matmul_kernels(peaks, flush, only="bfp_matmul_subbyte")))
        return
    if only == "k4":
        log(f"K4 vs its plain version at {', '.join(K4_SHAPES)}, batch {BATCH} ({smi}):")
        log(json.dumps(check_attention_kernels(peaks, flush, only="attn_decode_pos_major")))
        return
    if only == "k5":
        log(f"K5 vs its plain version at {', '.join(K5_SHAPES)}, batch {BATCH} ({smi}):")
        log(json.dumps(check_attention_kernels(peaks, flush, only="attn_decode_head_major",
                                               sweep=True)))
        return
    if only == "m_sweep":
        log(f"K1, K2, K3 over M (ms a 7B layer, {smi}):")
        log(json.dumps(m_sweep(flush)))
        return
    if only == "probes":
        rows, path_counts = run_probes(peaks, flush, libs["probes"])
        log(json.dumps({"kernels": kernel_entries(rows, path_counts)}))
        return
    t0 = time.perf_counter()
    log(f"kernels vs plain versions at 7B decode shapes, batch {BATCH} (the matmuls also "
        f"{PREFILL_M} rows):")
    rows = check_matmul_kernels(peaks, flush)
    rows["actq_split"] = check_actq_split(peaks, flush)
    log(f"K2 and K3 under PDL: unsynchronised calls on one workspace ({smi}):")
    for kname, race in check_pdl_race().items():
        rows[kname]["pdl_race"] = race
    rows.update(check_attention_kernels(peaks, flush))
    for r in rows.values():
        for pre in ("", "prefill_"):
            if pre + "bound_bytes_ms" in r:
                r[pre + "bound_ms"] = max(r[pre + "bound_bytes_ms"], r[pre + "bound_ops_ms"])
                r[pre + "bound_by"] = ("bytes" if r[pre + "bound_bytes_ms"] >= r[pre + "bound_ops_ms"]
                                       else "operations")

    log(f"phase 2 (the kernels against their plain versions) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    path_counts = run_llama(smi)
    log(f"phases 3-5 (Llama) took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    path_counts.update(run_opt())
    log(f"phase 6 (OPT) took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    ppl, path_counts["ppl"] = run_ppl()
    torch.cuda.empty_cache()
    qat, path_counts["qat"] = run_qat()
    torch.cuda.empty_cache()
    probe_rows, probe_counts = run_probes(peaks, flush, libs["probes"])
    rows.update(probe_rows)
    path_counts.update(probe_counts)
    torch.cuda.empty_cache()
    tail, tail_counts = run_tail(peaks, flush)
    path_counts.update(tail_counts)
    for kname, shapes in tail["tail"]["bert"]["matmuls"].items():
        rows[kname]["bert_shapes"] = shapes
    torch.cuda.empty_cache()
    stats, stats_counts = run_stats()
    path_counts.update(stats_counts)
    torch.cuda.empty_cache()
    search, head_dims, search_counts = run_search(peaks, flush)
    path_counts.update(search_counts)
    for kname, by_shape in head_dims.items():
        rows[kname]["head_dims"] = by_shape
        rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"],
                                         *(r["max_abs_err"] for r in by_shape.values()))
    torch.cuda.empty_cache()
    parallel, parallel_counts = run_parallel(smi)
    path_counts.update(parallel_counts)
    torch.cuda.empty_cache()
    scripts, scripts_counts = run_scripts(smi)
    path_counts.update(scripts_counts)

    log("(matmul rows and actq_split: sums over one Llama-2-7B layer's four projections "
        "at batch 8, K2's and K3's including their actq_split, opt_mlp_ms: OPT-6.7B fc1 and fc2 at "
        "batch 8; attention rows: one call "
        "at batch 8, 32 heads; probe rows: P8/P9/P1/P3/P2/P4-P7 sums over the four "
        "projections at M = 8, ms of ship (P8/P9), v2 (P1), v4_bf16s (P3), "
        "int8_bf16s (P2), c32_t1 (P4/P7), c32_k512 (P6/P5), band_sum one call a "
        "shape, P11 one call at b = 32, S = 256, ms of quant/f32, P12/P13 the same, ms of "
        "full / v3_masks, P10 one call at L = 8192, b = 32, ms of index; every variant "
        "under variants)")
    print(json.dumps(ppl), flush=True)
    print(json.dumps(qat), flush=True)
    print(json.dumps(tail), flush=True)
    print(json.dumps(stats), flush=True)
    print(json.dumps(search), flush=True)
    print(json.dumps(parallel), flush=True)
    print(json.dumps(scripts), flush=True)
    print(json.dumps({"kernels": kernel_entries(rows, path_counts)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if "--parallel-rank" in sys.argv:  # a rank of phase 13, started by run_parallel
        i = sys.argv.index("--parallel-rank")
        parallel_rank(int(sys.argv[i + 1]), int(sys.argv[i + 2]), Path(sys.argv[i + 3]))
    flags = {"--k1-only": "k1", "--k2-only": "k2", "--k3-only": "k3", "--k4-only": "k4",
             "--k5-only": "k5", "--m-sweep": "m_sweep", "--probes-only": "probes",
             "--ppl-only": "ppl", "--qat-only": "qat", "--tail-only": "tail",
             "--stats-only": "stats", "--search-only": "search",
             "--parallel-only": "parallel", "--scripts-only": "scripts"}
    main(only=next((flags[a] for a in sys.argv[1:] if a in flags), None))
