"""Operations and bytes of the work a run asked for, counted from shapes.

A kernel's bound is the larger of its bytes over the card's memory rate
and its operations over the peak of the units it computes on: K2 (the
int8-code matmul) on the bf16 tensor cores, K4/K5 (decode attention) on
the float32 CUDA cores. Each input byte is counted once and each output
byte once, whatever a kernel reads again; attention counts only the
positions filled for live requests.
"""

from __future__ import annotations


def llama_linears(dims: dict) -> list[tuple[int, int]]:
    """(N, K) of a layer's fused linears as served: qkv, o, gate_up, down."""
    h, inter = dims["hidden_size"], dims["intermediate_size"]
    kvh = dims["num_key_value_heads"] * (h // dims["num_attention_heads"])
    return [(h + 2 * kvh, h), (h, h), (2 * inter, h), (h, inter)]


def linear_params(dims: dict, family: str) -> int:
    """Weights of one decoder layer's linears."""
    h = dims["hidden_size"]
    if family == "llama":
        return sum(n * k for n, k in llama_linears(dims))
    return 4 * h * h + 2 * h * dims["ffn_dim"]


def k2_bound_s(m: int, n: int, k: int, peaks, block: int = 16) -> float:
    """int8 codes (1 byte) and float32 scales (one a block of K) of the
    weight, x and y in float32; 2 M N K operations on the bf16 peak."""
    nbytes = n * k + 4 * n * (k // block) + 4 * m * (k + n)
    return max(nbytes / peaks[0], 2 * m * n * k / peaks[2])


def attn_bytes(filled: int, rows: int, dims: dict, block: int = 16) -> int:
    """Decode attention of ``rows`` query rows over ``filled`` cached
    positions in all: K and V codes (1 byte) and scales (float32, one a
    block of head_dim) of every kv head; q and the output in float32."""
    nh, nkv = dims["num_attention_heads"], dims["num_key_value_heads"]
    hd = dims["hidden_size"] // nh
    per_pos = nkv * (2 * hd + 2 * (hd // block) * 4)
    return filled * per_pos + rows * nh * hd * 4 * 2 + rows * 4


def attn_flops(filled: int, dims: dict) -> int:
    """Scores and probs times V: 4 head_dim operations a position and
    query head."""
    nh = dims["num_attention_heads"]
    return 4 * (dims["hidden_size"] // nh) * nh * filled


def model_flops_serve(steps: list, dims: dict) -> float:
    """Useful operations of the served tokens: each prompt token's linears
    and causal attention, the head on each prompt's last token, and each
    decode row's linears, attention over its filled positions and head.
    Padding rows and idle slots are not counted."""
    L = dims["num_hidden_layers"]
    lin = 2 * linear_params(dims, "llama")
    head = 2 * dims["hidden_size"] * dims["vocab_size"]
    total = 0.0
    for s in steps:
        total += s["prompt_tokens"] * L * lin + L * attn_flops(s["prompt_sq"], dims)
        total += s["admitted"] * head
        total += s["row_steps"] * (L * lin + head) + L * attn_flops(s["filled"], dims)
    return total


def model_flops_eval(tokens: int, seq_len: int, dims: dict, family: str) -> float:
    """Operations of ``tokens`` evaluated in sequences of ``seq_len``:
    linears, causal attention and the head on every token."""
    L = dims["num_hidden_layers"]
    seqs = tokens / seq_len
    per_seq = (seq_len * (L * 2 * linear_params(dims, family)
                          + 2 * dims["hidden_size"] * dims["vocab_size"])
               + L * attn_flops(seq_len * (seq_len + 1) // 2, dims))
    return seqs * per_seq
