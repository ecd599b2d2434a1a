"""Plain reference of OPT under post-training quantization (the paper's
perplexity protocol): each sequence's causal LM loss.

From the equations: weights and biases fake-quantized once (BFP along the
input; biases in blocks of their own); every linear quantizes its input
along the features; learned positions at cumsum(mask) * mask - 1 + 2;
pre-LN decoder layers; q scaled by head_dim^-0.5 before the first
attention matmul, whose q is quantized along head_dim and k^T along
positions; additive causal mask, float32 softmax, probs quantized along
positions and v along head_dim; ReLU MLP; tied float32 head; the loss is
the mean cross-entropy of each token's successor.

``rnd`` rounds every activation after each operation (the control).
Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.quant import Arith

NEG_INF = float(np.finfo(np.float32).min)


def _identity(t):
    return t


class OptRef:
    def __init__(self, dims: dict, quant: dict, device, rnd=None):
        self.h = dims["hidden_size"]
        self.nh = dims["num_attention_heads"]
        self.hd = self.h // self.nh
        self.ar = Arith(quant)
        self.device = device
        self.r = rnd or _identity
        if not dims.get("do_layer_norm_before", True) or dims.get("activation_function",
                                                                    "relu") != "relu":
            raise ValueError("the reference takes pre-LN ReLU OPT")

    def ln(self, x, w, b):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return self.r((x - mean) * torch.rsqrt(var + 1e-5) * w + b)

    def linear(self, x, w, b):
        return self.r(torch.matmul(self.ar.act(x), w.t()) + b)

    def prepare(self, layer: dict) -> dict:
        """A layer's float tensors -> its PTQ-quantized tensors."""
        out = dict(layer)
        for name in ("q", "k", "v", "o", "fc1", "fc2"):
            out[name] = self.ar.weight(layer[name])
            out[name + "_b"] = self.ar.bias(layer[name + "_b"])
        return out

    def embed(self, top: dict, ids):
        """ids [1, s] -> hidden [1, s, h] (token and position embeddings)."""
        mask = torch.ones_like(ids)
        positions = torch.cumsum(mask, dim=1) * mask - 1
        return self.r(top["embed"][ids] + top["positions"][positions + 2])

    def layer(self, lw: dict, hidden):
        b, s, _ = hidden.shape
        ok = torch.ones((s, s), dtype=torch.bool, device=self.device).tril(0)[None, None]
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        amask = torch.where(ok, zero, torch.full_like(zero, NEG_INF))
        res = hidden
        h = self.ln(hidden, lw["attn_ln"], lw["attn_ln_b"])

        def heads(x):
            return x.reshape(b, s, self.nh, self.hd).transpose(1, 2).reshape(b * self.nh, s, self.hd)

        q = heads(self.r(self.linear(h, lw["q"], lw["q_b"]) * (self.hd ** -0.5)))
        k, v = heads(self.linear(h, lw["k"], lw["k_b"])), heads(self.linear(h, lw["v"], lw["v_b"]))
        att = self.r(torch.matmul(self.ar.act(q), self.ar.weight(k.transpose(1, 2))))
        att = torch.clamp_min(att.reshape(b, self.nh, s, s) + amask, NEG_INF).reshape(b * self.nh, s, s)
        att = self.r(torch.softmax(att, dim=-1))
        out = self.r(torch.matmul(self.ar.act(att), self.ar.weight(v)))
        out = out.reshape(b, self.nh, s, self.hd).transpose(1, 2).reshape(b, s, self.h)
        hidden = self.r(res + self.linear(out, lw["o"], lw["o_b"]))
        res = hidden
        h = self.ln(hidden, lw["mlp_ln"], lw["mlp_ln_b"])
        h = self.r(F.relu(self.linear(h, lw["fc1"], lw["fc1_b"])))
        return self.r(res + self.linear(h, lw["fc2"], lw["fc2_b"]))

    def loss(self, top: dict, hidden, ids):
        h = self.ln(hidden, top["final_ln"], top["final_ln_b"])
        logits = self.r(torch.matmul(h, top["embed"].t()))
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               ids[:, 1:].reshape(-1))


def sequence_losses(dims: dict, quant: dict, top: dict, make_layer, device, seqs,
                    rnd=None) -> list[float]:
    """The evaluated family's entry: each sequence's loss (see ``losses``)
    from a reference built of ``top`` and ``make_layer(i)``."""
    return losses(OptRef(dims, quant, device, rnd=rnd), top, make_layer,
                  dims["num_hidden_layers"], seqs)


@torch.no_grad()
def losses(ref: OptRef, top: dict, make_layer, L: int, seqs) -> list[float]:
    """Each sequence's loss (``seqs``: int64 [s] tensors), layer by layer:
    every layer's weights are made and quantized once for all sequences."""
    hiddens = [ref.embed(top, ids[None]) for ids in seqs]
    for i in range(L):
        lw = ref.prepare(make_layer(i))
        hiddens = [ref.layer(lw, h) for h in hiddens]
        del lw
    return [float(ref.loss(top, h, ids[None])) for h, ids in zip(hiddens, seqs)]
