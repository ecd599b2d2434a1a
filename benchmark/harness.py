"""One run of one cell: set-up, the measured window, the correctness check,
the metrics.

Everything a cell needs is found by name under the benchmark's folder:
``BENCHMARK.json`` (cells, metrics, bounds), ``configs/<config>.json``,
``traffic/<traffic>.json``, ``metrics/<metric>.py``,
``limits/<workload>.json``, and by the configuration's ``family``
``families/<family>.py`` (weights, and how the port is built of them) and
``reference/<family>.py`` (the plain reference: ``served_logits`` for a
served family, ``sequence_losses`` for an evaluated one). Two runners
serve every mix: ``serve`` (the family's serving loop, offline or as a
closed loop of streaming clients) and ``eval`` (the perplexity protocol,
``eval_lm_wikitext2`` over the PTQ forward). The program is imported only
inside the runners and the families' builders; the references never
import it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import traffic as gen
from .trace import Tracer, breakdown, busy_s

BENCH_DIR = Path(__file__).resolve().parent
clock = time.perf_counter
# the controls: the reference in a lower precision, in the program's place
ROUNDING = {"bf16": lambda t: t.to(torch.bfloat16).to(torch.float32), "tf32": None}


# ---------------------------------------------------------------- the spec
def load_cell(workload: str, bench_dir: Path = BENCH_DIR, bench_json: Path | None = None):
    """(spec, cell, config, traffic, end_to_end metrics, per_layer metrics,
    limits) of ``workload``."""
    bench_json = bench_json or bench_dir.parent / "BENCHMARK.json"
    spec = json.loads(bench_json.read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_json}")
    cell = cells[workload]
    config = json.loads((bench_dir / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{workload}.json").read_text())

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return (spec, cell, config, traffic, [m for m in spec["end_to_end"] if mine(m)],
            [m for m in spec["per_layer"] if mine(m)], limits)


def load_part(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``<kind>/<name>.py`` of the benchmark's folder."""
    path = bench_dir / kind / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``read(rec)`` of ``metrics/<name>.py``."""
    return load_part("metrics", name, bench_dir).read


# ---------------------------------------------------------------- records
@dataclass
class Request:
    prompt: list
    rid: int = -1
    client: int = -1  # closed loop: the client that sent it, and its next think time
    think: float = 0.0
    tokens: list = field(default_factory=list)
    times: list = field(default_factory=list)
    bucket: int = 0
    t_done: float | None = None


@dataclass
class Record:
    """What a run saw, on the window's clock (seconds from its start)."""
    workload: str
    family: str
    dims: dict
    traffic: dict
    window_s: float = 0.0
    spans: list = field(default_factory=list)  # (name, start, end)
    # serve: one dict a step() call: its span, requests admitted, their
    # prompt tokens (and sum of len * (len + 1) / 2), decode steps, live
    # rows summed over them, cache positions those rows read, tokens out
    steps: list = field(default_factory=list)
    batches: list = field(default_factory=list)  # eval: (start, end, tokens)
    requests: list = field(default_factory=list)
    events: list | None = None  # traced device events (name, start, dur)
    peaks: tuple = (3.35e12, 67e12, 989e12)


def card_peaks(name: str):
    """(bytes/s, float32 FLOP/s on the CUDA cores, dense bf16 FLOP/s) of a
    card, from NVIDIA's data sheets; the H100 SXM where the name says no
    other part."""
    table = {"H100 PCIe": (2.0e12, 51e12, 756e12), "H100 NVL": (3.9e12, 60e12, 835e12),
             "H200": (4.8e12, 67e12, 989e12), "H100": (3.35e12, 67e12, 989e12)}
    for key, peaks in table.items():
        if key in name:
            return peaks
    return table["H100"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------- serving
class Serve:
    """The family's serving loop (``families/<family>.py:serving``)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, family):
        if not hasattr(family, "serving"):
            raise ValueError(f"the {config['family']} family has no serving loop")
        self.batcher = family.serving(config, traffic, seed, device)
        _sync(device)

    def close(self):
        self.batcher = None


def _bucket(prompts, pb: int, max_len: int) -> int:
    return min(max(-(-len(p) // pb) * pb for p in prompts), max_len)


def serve_window(srv: Serve, rec: Record, seed: int, seconds: float, tracer: Tracer,
                 device) -> float:
    """Drive the batcher for ``seconds``; the window closes at the end of
    the step() in flight. -> the window's length."""
    tr = rec.traffic
    bt = srv.batcher
    cfg = tr["batcher"]
    pb, max_len = cfg["prompt_bucket"], cfg["max_len"]
    vocab = rec.dims["vocab_size"]
    closed = tr["mode"] == "closed_loop"
    if closed:
        n = tr["pool"]
        pool = gen.prompts(gen.lengths(tr["prompt_len"], n, seed), vocab, seed)
        think = gen.exponential_grid(n, tr["think_mean_s"], seed)
        offsets = gen.uniform_grid(tr["clients"], tr["start_spread_s"], seed)
    else:
        pool = gen.prompts(gen.lengths(tr["prompt_len"], tr["queue"], seed), vocab, seed)
    inflight: dict[int, Request] = {}
    emitted, done = bt._emitted, bt._done  # the batcher's outputs, its finished ids
    tracer.start()
    t0 = clock()
    now = lambda: clock() - t0
    nxt = 0
    due = []  # closed loop: (time, client)
    if closed:
        due = sorted((off, c) for c, off in enumerate(offsets))
    else:
        for p in pool:
            r = Request(prompt=p)
            r.rid = bt.submit(p)
            inflight[r.rid] = r
            rec.requests.append(r)
        nxt = len(pool)
    while True:
        t = now()
        if t >= seconds:
            break
        while due and due[0][0] <= t:
            _, c = due.pop(0)
            r = Request(prompt=pool[nxt % len(pool)], client=c, think=think[nxt % len(think)])
            nxt += 1
            r.rid = bt.submit(r.prompt)
            inflight[r.rid] = r
            rec.requests.append(r)
        if not inflight:
            wake = min(due[0][0] if due else seconds, seconds)
            time.sleep(max(0.0, wake - t))
            rec.spans.append(("wait", t, now()))
            continue
        ts = now()
        bt.step()
        te = now()
        admitted, new_tokens, decode_steps, filled, row_steps = [], 0, 0, 0, 0
        finished = []
        for rid, r in inflight.items():
            got = emitted[rid]
            k = len(got) - len(r.tokens)
            if k <= 0:
                continue
            first = not r.tokens
            if first:
                admitted.append(r)
            base = len(r.tokens)
            r.tokens.extend(got[base:])
            r.times.extend([te] * k)
            new_tokens += k
            d = k - 1 if first else k  # this call's decode steps of r
            e = 1 if first else base  # tokens r had before them
            decode_steps = max(decode_steps, d)
            filled += d * (len(r.prompt) + e) + d * (d - 1) // 2
            row_steps += d
            if rid in done:
                r.t_done = te
                finished.append(rid)
        if admitted:
            bucket = _bucket([r.prompt for r in admitted], pb, max_len)
            for r in admitted:
                r.bucket = bucket
        for rid in finished:
            r = inflight.pop(rid)
            if closed:
                due.append((r.t_done + r.think, r.client))
        due.sort()
        rec.spans.append(("step.admit" if admitted else "step.decode", ts, te))
        rec.steps.append({
            "start": ts, "end": te, "admitted": len(admitted),
            "prompt_tokens": sum(len(r.prompt) for r in admitted),
            "prompt_sq": sum(len(r.prompt) * (len(r.prompt) + 1) // 2 for r in admitted),
            "decode_steps": decode_steps, "row_steps": row_steps, "filled": filled,
            "new_tokens": new_tokens,
        })
    t_end = now()
    _sync(device)
    tracer.stop(t0, t0 + t_end)
    return t_end


def serve_metrics(rec: Record) -> dict:
    """``decode_tok_s``, and ``itl_p95_ms`` for the streaming mixes: every
    gap between two tokens of one request as the harness received them."""
    tokens = sum(s["new_tokens"] for s in rec.steps)
    out = {"decode_tok_s": tokens / rec.window_s}
    gaps = []
    for r in rec.requests:
        gaps.extend(b - a for a, b in zip(r.times, r.times[1:]))
    if gaps:
        out["itl_p95_ms"] = float(np.percentile(np.asarray(gaps), 95)) * 1e3
    return out


def serve_sample(rec: Record, seed: int, n: int) -> list:
    """Finished requests to check: the longest, then others drawn from the
    seed."""
    done = [r for r in rec.requests if r.t_done is not None]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].prompt) + len(done[i].tokens))
    rest = [i for i in gen.rng(seed, 6).permutation(len(done)) if i != longest]
    return [done[i] for i in [longest] + rest[:n - 1]]


def _gap_numbers(gaps: list) -> dict:
    """Of each checked request's gaps (how far each served token's logit
    lies below the reference's best): the largest of the requests' mean
    gaps (the number compared, so that one faulty request in the sample
    shows undiluted), the mean over all tokens and the widest."""
    flat = torch.cat(gaps)
    return {"request_mean_gap": max(float(g.mean()) for g in gaps),
            "mean_gap": float(flat.mean()), "max_gap": float(flat.max())}


def serve_check(config: dict, traffic: dict, seed: int, sample: list, device, family,
                reference, controls=()) -> tuple[dict, dict]:
    """(the program's numbers, each control's numbers). A control is the
    reference in a lower precision ("bf16"; "tf32": TF32 matmuls) in the
    program's place: its token is the one it puts first at each position of
    the same prompts and served tokens."""
    dims = config["model"]
    max_len = traffic["batcher"]["max_len"]
    reqs = [{"prompt": r.prompt, "tokens": r.tokens, "bucket": r.bucket} for r in sample]

    def logits_of(control):
        with _precision(control):
            return reference.served_logits(
                dims, config["quant"], family.top(dims, seed, device),
                lambda i: family.layer(dims, seed, i, device), device, max_len, reqs,
                rnd=ROUNDING[control] if control else None)

    logits = logits_of(None)
    gaps = [lg.amax(-1) - lg.gather(1, torch.as_tensor(r["tokens"], device=device)[:, None])[:, 0]
            for lg, r in zip(logits, reqs)]
    out = {**_gap_numbers(gaps), "checked_requests": len(gaps),
           "checked_tokens": sum(int(g.numel()) for g in gaps),
           "first_token_gap": max(float(g[0]) for g in gaps),
           "first_nonzero": sorted(int((g > 0).nonzero()[0]) if bool((g > 0).any()) else len(g)
                                   for g in gaps)}
    ctl = {}
    for control in controls:
        clog = logits_of(control)
        ctl[control] = _gap_numbers([lg.amax(-1) - lg.gather(1, c.argmax(-1)[:, None])[:, 0]
                                     for lg, c in zip(logits, clog)])
        del clog
    return out, ctl


class _precision:
    """The reference in float32 with TF32 off, or a control's precision:
    "tf32" turns TF32 on for its matmuls."""

    def __init__(self, control):
        self.control = control

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.control == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


# ---------------------------------------------------------------- the eval
class Eval:
    """The perplexity protocol over the PTQ forward, through the port's
    registry of families."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, family):
        from llm_mixed_q_torch.models import get_ptq_preparer
        from llm_mixed_q_torch.models.api import make_forward

        fam = config["family"]
        dims = config["model"]
        self.pconfig = family.program_config(config)
        layers = (family.program_layer(family.layer(dims, seed, i, device))
                  for i in range(dims["num_hidden_layers"]))
        self.params = get_ptq_preparer(fam)({**family.program_top(family.top(dims, seed, device)),
                                             "layers": layers}, self.pconfig)
        self.params["layers"] = list(self.params["layers"])
        self.fwd = make_forward(fam, "lm", self.pconfig, quantize_weights=False,
                                with_labels=True)
        self.seq_len = traffic["seq_len"]
        self.batch = traffic["batch"]
        ids = torch.zeros((self.batch, self.seq_len), dtype=torch.int64, device=device)
        with torch.inference_mode():
            float(self.fwd(self.params, ids, torch.ones_like(ids), ids)["loss"])
        _sync(device)

    def close(self):
        self.params = None


def eval_window(ev: Eval, rec: Record, seed: int, seconds: float, tracer: Tracer, device):
    from llm_mixed_q_torch.eval.eval_lm import eval_lm_wikitext2

    vocab = rec.dims["vocab_size"]
    seqs, losses = [], []
    tracer.start()
    t0 = clock()
    now = lambda: clock() - t0

    def loader():
        i = 0
        while now() < seconds:
            rows = np.stack([gen.sequence(i * ev.batch + j, ev.seq_len, vocab, seed)
                             for j in range(ev.batch)])
            seqs.append(rows)
            i += 1
            yield {"input_ids": rows, "attention_mask": np.ones_like(rows), "labels": rows}

    def fwd(params, ids, mask, labels):
        ts = now()
        out = ev.fwd(params, ids, mask, labels)
        loss = float(out["loss"])
        te = now()
        losses.append(loss)
        rec.spans.append(("eval_batch", ts, te))
        rec.batches.append((ts, te, ids.numel()))
        return out

    eval_lm_wikitext2(fwd, ev.params, loader())
    t_end = now()
    _sync(device)
    tracer.stop(t0, t0 + t_end)
    rec.requests = [{"ids": s, "loss": l} for s, l in zip(seqs, losses)]
    return t_end


def eval_metrics(rec: Record) -> dict:
    return {"eval_tok_s": sum(b[2] for b in rec.batches) / rec.window_s}


def eval_sample(rec: Record, seed: int, n: int) -> list:
    idx = gen.rng(seed, 7).permutation(len(rec.requests))[:n]
    return [rec.requests[i] for i in sorted(idx)]


def eval_check(config: dict, seed: int, sample: list, device, family, reference,
               controls=()) -> tuple[dict, dict]:
    """(the widest gap between a batch's loss and the reference's, the same
    of each control's losses)."""
    dims = config["model"]
    seqs = [torch.as_tensor(row, device=device) for s in sample for row in s["ids"]]
    per_batch = len(sample[0]["ids"])

    def losses(control):
        with _precision(control):
            flat = reference.sequence_losses(
                dims, config["quant"], family.top(dims, seed, device),
                lambda i: family.layer(dims, seed, i, device), device, seqs,
                rnd=ROUNDING[control] if control else None)
        return [float(np.mean(flat[k:k + per_batch])) for k in range(0, len(flat), per_batch)]

    want = losses(None)

    def gap(got):
        return {"max_loss_gap": max(abs(a - b) for a, b in zip(got, want))}

    out = {**gap([s["loss"] for s in sample]), "checked_batches": len(sample)}
    return out, {control: gap(losses(control)) for control in controls}


def judge(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """Each compared number beside its limit, and whether all are within."""
    checks = {key: {"value": numbers.get(key, float("nan")), "limit": limit}
              for key, limit in limits.items()}
    return checks, all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values())


def host_speed(device) -> dict:
    """How fast this host drives the card, read once the window has closed:
    the CPUs this process may run on, the best of three times of a fixed
    piece of Python (ms), and of 2,000 launches of a one-element kernel
    (us a launch, the host's share of a decode step's ~7,700)."""
    def best(fn):
        times = []
        for _ in range(3):
            t = clock()
            fn()
            times.append(clock() - t)
        return min(times)

    x = torch.zeros(1, device=device)

    def launches():
        for _ in range(2000):
            x.add_(1.0)
        _sync(device)

    _sync(device)
    return {"host.cpus": len(os.sched_getaffinity(0)),
            "host.py_ms": 1e3 * best(lambda: sum(i * i for i in range(200_000))),
            "host.launch_us": 1e6 * best(launches) / 2000}


def _step_summary(rec) -> str:
    """One line on a serving window's step() calls, for the run's log."""
    plain = [s for s in rec.steps if not s["admitted"] and s["decode_steps"]]
    adm = [s for s in rec.steps if s["admitted"]]
    n = sum(s["decode_steps"] for s in plain)
    step_ms = 1e3 * sum(s["end"] - s["start"] for s in plain) / n if n else float("nan")
    calls = [round(1e3 * (s["end"] - s["start"])) for s in adm]
    return (f"steps: {len(rec.steps)} calls, {n} plain decode steps at {step_ms:.2f} ms, "
            f"{len(adm)} admitting calls (ms: {calls[:12]})")


# ---------------------------------------------------------------- one run
RUNNERS = {"serve": (Serve, serve_window, serve_metrics),
           "eval": (Eval, eval_window, eval_metrics)}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, bench_dir: Path = BENCH_DIR, bench_json: Path | None = None,
             controls=(), log=print) -> dict:
    """One run of ``workload``: the result line's object, with the numbers
    compared under "checks", last. With ``controls``, each control's
    numbers go through the same limits under "controls"."""
    device = torch.device(device)
    spec, cell, config, traffic, e2e, per_layer, limits = load_cell(workload, bench_dir,
                                                                   bench_json)
    family = load_part("families", config["family"], bench_dir)
    reference = load_part("reference", config["family"], bench_dir)
    rec = Record(workload, config["family"], config["model"], traffic)
    if device.type == "cuda":
        rec.peaks = card_peaks(torch.cuda.get_device_name(device))
        torch.cuda.reset_peak_memory_stats(device)
    setup, window, metrics = RUNNERS[traffic["runner"]]
    program = setup(config, traffic, seed, device, family)
    tracer = Tracer(trace, device)
    setup_s = clock() - t_start
    log(f"set-up {setup_s:.2f} s")
    rec.window_s = window(program, rec, seed, seconds, tracer, device)
    log(f"window {rec.window_s:.2f} s, {clock() - t_start:.2f} s from the start")
    host = host_speed(device)
    log("host: " + ", ".join(f"{k[5:]} {v:.4g}" for k, v in host.items()))
    if rec.steps:
        host["admissions"] = sum(1 for s in rec.steps if s["admitted"])
        log(_step_summary(rec))
    rec.events = tracer.events
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    program.close()
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    values = {"setup_s": setup_s, **metrics(rec)}
    n = traffic["check"]
    t_check = clock()
    if traffic["runner"] == "serve":
        sample = serve_sample(rec, seed, n["requests"])
        served = [r for r in rec.requests if r.tokens]  # admitted in the window
        failed = sum(1 for r in served if any(not 0 <= t < rec.dims["vocab_size"]
                                              for t in r.tokens))
        numbers, ctl = (serve_check(config, traffic, seed, sample, device, family, reference,
                                    controls) if sample else ({}, {}))
        attempted = len(served)
    else:
        sample = eval_sample(rec, seed, n["sequences"])
        failed = sum(1 for r in rec.requests if not math.isfinite(r["loss"]))
        numbers, ctl = (eval_check(config, seed, sample, device, family, reference, controls)
                        if sample else ({}, {}))
        attempted = len(rec.requests)
    log(f"check {clock() - t_check:.2f} s")
    checks, within = judge(numbers, limits)
    correct = bool(sample) and failed == 0 and within

    if trace:
        out_metrics = {}
        for m in per_layer:
            v = load_reader(m["name"], bench_dir)(rec)
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        out_metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in e2e if m["name"] in values}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": out_metrics, "device": dev}
    if trace and rec.events is not None:
        dev["busy_s"] = busy_s(rec.events)
        dev["window_s"] = rec.window_s
        result["breakdown"] = breakdown(rec.events, sorted(rec.spans, key=lambda s: s[1]),
                                        rec.window_s)
    result["readings"] = {**{k: v for k, v in numbers.items() if k not in checks}, **host}
    if controls:
        result["controls"] = {}
        for control, cnum in ctl.items():
            cchecks, cwithin = judge(cnum, limits)
            result["controls"][control] = {"correct": bool(sample) and cwithin,
                                           "checks": cchecks,
                                           "readings": {k: v for k, v in cnum.items()
                                                        if k not in cchecks}}
    result["checks"] = checks
    return result
