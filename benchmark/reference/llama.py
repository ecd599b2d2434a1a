"""Plain reference of a quantized Llama-architecture model as it is served
from packed weights and a packed KV cache (Mistral-7B-v0.3 runs through
it: GQA, RoPE, RMSNorm, SwiGLU, untied head, no sliding window).

The served model, written from its equations:

- linears: x quantized along the input (BFP blocks), times the weight's
  stored form (BFP codes * scales along the input), float32;
- embedding and head in bfloat16 (the serving option): the table rounded
  to bf16, the final hidden rounded to bf16 before the head's float32
  product;
- RMSNorm in float32; RoPE tables in numpy float32, quantized to fixed
  point, the rotation in float32;
- the prompt's attention (prefill): q quantized along head_dim, k^T along
  positions, scores / sqrt(head_dim), additive causal and padding mask,
  float32 softmax, probs quantized along positions, v along head_dim;
- the cache: every position's K (after RoPE) and V stored as BFP codes
  along head_dim; a decode step's attention reads the stored values:
  q quantized along head_dim, scores divided by sqrt(head_dim), positions
  past the token's own masked, softmax with a float64 denominator, probs
  quantized in blocks along the cache's positions.

Prompts are right-padded to the admission's bucket with id 0, as the
batcher pads them; the padded positions take part in k^T's blocks.

``rnd`` rounds every activation after each operation (the control: the
same model in bfloat16). Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.quant import Arith

NEG_INF = float(np.finfo(np.float32).min)


def rope_tables(n: int, head_dim: int, theta: float, device):
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    t = np.arange(n, dtype=np.float32)
    emb = np.concatenate([np.outer(t, inv_freq)] * 2, axis=-1)
    return (torch.as_tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(emb), dtype=torch.float32, device=device))


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _identity(t):
    return t


def to_bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


class LlamaServedRef:
    """``layers``: per layer a dict of float32 tensors {input_ln, post_ln,
    q, k, v, o, gate, up, down} ([out, in]); ``top``: {embed, lm_head,
    norm}. Built layer by layer from ``make_layer(i)``, keeping only the
    stored weights."""

    def __init__(self, dims: dict, quant: dict, top: dict, make_layer, device,
                 max_len: int, rnd=None):
        self.h = dims["hidden_size"]
        self.nh = dims["num_attention_heads"]
        self.nkv = dims["num_key_value_heads"]
        self.hd = self.h // self.nh
        self.eps = dims["rms_norm_eps"]
        self.theta = dims["rope_theta"]
        self.L = dims["num_hidden_layers"]
        self.ar = Arith(quant)
        self.device = device
        self.max_len = max_len
        self.r = rnd or _identity
        self.embed = to_bf16(top["embed"])
        self.lm_head = to_bf16(top["lm_head"])
        self.norm = top["norm"]
        self.layers = []
        for i in range(self.L):
            w = make_layer(i)
            st = self.ar.weight_stored
            self.layers.append({
                "input_ln": w["input_ln"], "post_ln": w["post_ln"],
                "qkv": st(torch.cat([w["q"], w["k"], w["v"]], dim=0)),
                "o": st(w["o"]),
                "gate_up": st(torch.cat([w["gate"], w["up"]], dim=0)),
                "down": st(w["down"]),
                "splits": (w["q"].shape[0], w["k"].shape[0]),
                "inter": w["gate"].shape[0],
            })
            del w
        self.cache = None

    # ------------------------------------------------------------- pieces
    def rms(self, x, w):
        var = x.square().mean(dim=-1, keepdim=True)
        return self.r(w * (x * torch.rsqrt(var + self.eps)))

    def linear(self, x, w):
        """x [..., K] quantized along K, times the stored weight [N, K]."""
        lead = x.shape[:-1]
        x2 = self.ar.act(x.reshape(-1, x.shape[-1]).contiguous())
        return self.r(torch.matmul(x2, w.t())).reshape(*lead, w.shape[0])

    def qkv(self, lw, h):
        b, s, _ = h.shape
        out = self.linear(h, lw["qkv"])
        nq, nk = lw["splits"]
        q = out[..., :nq].reshape(b, s, self.nh, self.hd).transpose(1, 2)
        k = out[..., nq:nq + nk].reshape(b, s, self.nkv, self.hd).transpose(1, 2)
        v = out[..., nq + nk:].reshape(b, s, self.nkv, self.hd).transpose(1, 2)
        return q, k, v

    def rope(self, q, k, n, pos):
        cos, sin = rope_tables(n, self.hd, self.theta, self.device)
        cos, sin = self.ar.table(cos), self.ar.table(sin)
        idx = pos.clamp(0, cos.shape[0] - 1)
        cos, sin = cos[idx][:, None], sin[idx][:, None]
        return (self.r((q * cos) + (_rotate_half(q) * sin)),
                self.r((k * cos) + (_rotate_half(k) * sin)))

    def mlp(self, lw, h):
        gu = self.linear(h, lw["gate_up"])
        gate, up = gu[..., :lw["inter"]], gu[..., lw["inter"]:]
        return self.linear(self.r(F.silu(gate) * up), lw["down"])

    def logits(self, h):
        h = self.rms(h, self.norm)
        return torch.matmul(to_bf16(h), self.lm_head.t())

    def _store(self, x):
        """x [b, nkv, s, hd] -> its stored (BFP codes along hd) values."""
        return self.ar.weight_stored(x)

    # ------------------------------------------------------------- serving
    def start(self, rows: int):
        """An empty cache for ``rows`` sequences: per layer K^T [b, nkv,
        hd, max_len] and V [b, nkv, max_len, hd], stored values."""
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=self.device)
        self.cache = [(z(rows, self.nkv, self.hd, self.max_len),
                       z(rows, self.nkv, self.max_len, self.hd)) for _ in range(self.L)]

    @torch.no_grad()
    def prefill(self, ids, mask, rows):
        """ids, mask [n, S] (bucket-padded) into cache ``rows`` [n] ->
        logits [n, S, V]."""
        n, s = ids.shape
        hidden = self.r(self.embed[ids])
        pos = torch.arange(s, device=self.device)[None, :].expand(n, s)
        ok = torch.ones((s, s), dtype=torch.bool, device=self.device).tril(0)[None, None]
        ok = ok & mask[:, None, None, :].to(torch.bool)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        amask = torch.where(ok, zero, torch.full_like(zero, NEG_INF))
        rep = self.nh // self.nkv
        for i, lw in enumerate(self.layers):
            res = hidden
            q, k, v = self.qkv(lw, self.rms(hidden, lw["input_ln"]))
            q, k = self.rope(q, k, s, pos)
            kc, vc = self.cache[i]
            kc[rows, :, :, :s] = self._store(k).transpose(2, 3)
            vc[rows, :, :s] = self._store(v)
            kr = k[:, :, None].expand(n, self.nkv, rep, s, self.hd).reshape(n, self.nh, s, self.hd)
            vr = v[:, :, None].expand(n, self.nkv, rep, s, self.hd).reshape(n, self.nh, s, self.hd)
            qq = self.ar.act(q.reshape(-1, s, self.hd)).reshape(q.shape)
            kt = kr.transpose(2, 3)
            kq = self.ar.weight(kt.reshape(-1, self.hd, s)).reshape(kt.shape)
            att = self.r(torch.matmul(qq, kq) / math.sqrt(self.hd))
            att = torch.clamp_min(att + amask, NEG_INF)
            att = self.r(torch.softmax(att, dim=-1))
            pq = self.ar.act(att.reshape(-1, s, s)).reshape(att.shape)
            vq = self.ar.weight(vr.reshape(-1, s, self.hd)).reshape(vr.shape)
            ctx = self.r(torch.matmul(pq, vq)).transpose(1, 2).reshape(n, s, self.h)
            hidden = self.r(res + self.linear(ctx, lw["o"]))
            res = hidden
            hidden = self.r(res + self.mlp(lw, self.rms(hidden, lw["post_ln"])))
        return self.logits(hidden)

    @torch.no_grad()
    def decode(self, tokens, positions):
        """One token a cached sequence: tokens, positions [rows] (the
        token's position) -> logits [rows, V]."""
        b = tokens.shape[0]
        S = self.max_len
        positions = positions.clamp(max=S - 1)
        hidden = self.r(self.embed[tokens[:, None]])
        rep = self.nh // self.nkv
        sqrt_hd = torch.full((), math.sqrt(self.hd), dtype=torch.float32, device=self.device)
        valid = torch.arange(S, device=self.device) <= positions[:, None, None, None]
        rows = torch.arange(b, device=self.device)
        for i, lw in enumerate(self.layers):
            res = hidden
            q, k, v = self.qkv(lw, self.rms(hidden, lw["input_ln"]))
            q, k = self.rope(q, k, S, positions[:, None])
            kc, vc = self.cache[i]
            kc[rows, :, :, positions] = self._store(k)[:, :, 0, :]
            vc[rows, :, positions] = self._store(v)[:, :, 0, :]
            qq = self.ar.act(q.reshape(b * self.nh, 1, self.hd)).reshape(b, self.nkv, rep, self.hd)
            sc = self.r(torch.einsum("bkrd,bkds->bkrs", qq, kc) / sqrt_hd)
            sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
            m = sc.amax(dim=-1, keepdim=True)
            e = torch.exp(sc - m)
            p = self.r(e / e.double().sum(dim=-1, keepdim=True).float())
            pq = self.ar.act(p.reshape(b * self.nkv * rep, 1, S)).reshape(p.shape)
            ctx = self.r(torch.einsum("bkrs,bksd->bkrd", pq, vc))
            ctx = ctx.reshape(b, self.nh, 1, self.hd).transpose(1, 2).reshape(b, 1, self.h)
            hidden = self.r(res + self.linear(ctx, lw["o"]))
            res = hidden
            hidden = self.r(res + self.mlp(lw, self.rms(hidden, lw["post_ln"])))
        return self.logits(hidden[:, 0])


def served_logits(dims: dict, quant: dict, top: dict, make_layer, device, max_len: int,
                  requests, rnd=None):
    """The served family's entry: teacher-forced logits of each request's
    served tokens (see ``teacher_forced``) from a reference built of
    ``top`` and ``make_layer(i)``; ``rnd`` rounds as in ``LlamaServedRef``."""
    return teacher_forced(LlamaServedRef(dims, quant, top, make_layer, device, max_len,
                                         rnd=rnd), requests)


@torch.no_grad()
def teacher_forced(ref: LlamaServedRef, requests, pad_id: int = 0):
    """Teacher-forced logits of each request's served tokens.

    ``requests``: dicts {prompt: list[int], tokens: list[int], bucket: int}.
    -> list of float32 tensors [len(tokens), V] on the reference's device:
    row t is the logits from which served token t was chosen."""
    dev = ref.device
    n = len(requests)
    ref.start(n)
    out = [[None] * len(r["tokens"]) for r in requests]
    for bucket in sorted({r["bucket"] for r in requests}):
        rows = [i for i, r in enumerate(requests) if r["bucket"] == bucket]
        ids = torch.full((len(rows), bucket), pad_id, dtype=torch.int64, device=dev)
        mask = torch.zeros((len(rows), bucket), dtype=torch.int64, device=dev)
        mask[:, 0] = 1
        for j, i in enumerate(rows):
            p = requests[i]["prompt"]
            ids[j, :len(p)] = torch.as_tensor(p, device=dev)
            mask[j, :len(p)] = 1
        logits = ref.prefill(ids, mask, torch.as_tensor(rows, device=dev))
        for j, i in enumerate(rows):
            out[i][0] = logits[j, len(requests[i]["prompt"]) - 1]
        del logits
    steps = max(len(r["tokens"]) for r in requests)
    for t in range(1, steps):
        live = [i for i, r in enumerate(requests) if t < len(r["tokens"])]
        tok = torch.as_tensor([requests[i]["tokens"][t - 1] if t < len(requests[i]["tokens"])
                               else 0 for i in range(n)], device=dev)
        pos = torch.as_tensor([len(r["prompt"]) + t - 1 for r in requests], device=dev)
        logits = ref.decode(tok, pos)
        for i in live:
            out[i][t] = logits[i]
    return [torch.stack(rows) for rows in out]
