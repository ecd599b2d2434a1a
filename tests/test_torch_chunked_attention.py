"""The port's kv-chunked two-pass attention (``ops/attention.py``) and the
Llama forward that takes it (``attention_chunk``), against the JAX
package on the CPU.

Tolerances are the JAX package's own (tests/test_chunked_attention.py):
rtol/atol 2e-5 for the attention (each chunk's float32 sum of
exponentials is taken in another order, which can flip the last bit of a
probability and so a prob-quantizer rounding), 1e-4 for the logits."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init
from llm_mixed_q_tpu.models.llama import LlamaQuantizedConfig as JaxConfig
from llm_mixed_q_tpu.models.llama import llama_for_causal_lm as jax_forward
from llm_mixed_q_tpu.ops.attention import chunked_quantized_attention as jax_chunked
from llm_mixed_q_tpu.utils.toml_io import load_config
from llm_mixed_q_torch.models.hf_loader import params_from_jax
from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig, llama_for_causal_lm
from llm_mixed_q_torch.ops.attention import chunked_quantized_attention
from llm_mixed_q_torch.ops.functions import quantized_matmul

RNG = np.random.default_rng(3)
TOMLS = "configs/quantization/{}.toml"
BYPASS = {"name": "integer", "bypass": True}


def _mm(name):
    return BYPASS if name == "bypass" else load_config(TOMLS.format(name))["default"]


def _causal_mask(b, S):
    m = np.triu(np.full((S, S), -1e9, dtype=np.float32), k=1)
    return np.ascontiguousarray(np.broadcast_to(m, (b, 1, S, S)))


def _qkv(b, h, S, K, d):
    return [RNG.standard_normal(s).astype(np.float32) for s in
            ((b, h, S, d), (b, h, K, d), (b, h, K, d))]


def _jax(q, k, v, mask, cfg, chunk):
    fn = jax.jit(lambda q, k, v, m: jax_chunked(q, k, v, m, cfg, cfg, math.sqrt(q.shape[-1]),
                                                chunk=chunk))
    return np.asarray(fn(q, k, v, mask))


def _port(q, k, v, mask, cfg, chunk):
    t = lambda a: None if a is None else torch.from_numpy(a)
    return chunked_quantized_attention(t(q), t(k), t(v), t(mask), cfg, cfg,
                                       math.sqrt(q.shape[-1]), chunk=chunk).numpy()


@pytest.mark.parametrize("arith", ["bfp_6bit", "block_minifloat", "log", "bypass"])
@pytest.mark.parametrize("S,chunk", [(64, 32), (96, 32), (40, 16)])
def test_chunked_matches_jax(arith, S, chunk):
    """Causal masks, K a multiple of the chunk and not (40 = 2.5 chunks:
    the last one padded with masked positions)."""
    q, k, v = _qkv(2, 2, S, S, 32)
    mask = _causal_mask(2, S)
    cfg = _mm(arith)
    np.testing.assert_allclose(_port(q, k, v, mask, cfg, chunk), _jax(q, k, v, mask, cfg, chunk),
                               rtol=2e-5, atol=2e-5)


def test_chunked_no_mask_cross_attention_matches_jax():
    q, k, v = _qkv(1, 2, 16, 48, 32)
    cfg = _mm("bfp_6bit")
    got = _port(q, k, v, None, cfg, 16)
    assert got.shape == (1, 2, 16, 32)
    np.testing.assert_allclose(got, _jax(q, k, v, None, cfg, 16), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arith", ["bfp_6bit", "block_log", "integer"])
def test_chunked_matches_the_naive_path(arith):
    """In the port alone: the chunked pair against quantized matmul_0,
    float32 softmax, quantized matmul_1 over the whole score matrix."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 80, 80, 32))
    mask = torch.from_numpy(_causal_mask(2, 80))
    cfg = _mm(arith)
    s = torch.clamp_min(quantized_matmul(q, k.transpose(2, 3), cfg) / math.sqrt(32) + mask, -1e9)
    want = quantized_matmul(torch.softmax(s, dim=-1), v, cfg)
    got = chunked_quantized_attention(q, k, v, mask, cfg, cfg, math.sqrt(32), chunk=32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def test_chunk_off_the_block_tiling_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 40, 40, 16))
    with pytest.raises(ValueError, match="tiling"):
        chunked_quantized_attention(q, k, v, None, BYPASS, BYPASS, 4.0, chunk=24)


@pytest.mark.parametrize("quant", ["bfp_6bit", "block_minifloat"])
def test_llama_forward_with_chunked_attention_matches_jax(quant):
    """A 2-layer Llama with ``attention_chunk = 32`` over 64 tokens: the
    port's logits against the JAX package's chunked forward at 1e-4, and
    against the port's naive forward at 1e-4."""
    tiny = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=2, max_position_embeddings=128,
                quant_config=TOMLS.format(quant))
    jc = JaxConfig(**tiny, attention_chunk=32)
    jp = jax_init(jc, seed=0)
    ids = RNG.integers(0, 96, size=(2, 64)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, i: jax_forward(p, i, None, config=jc)["logits"])(jp, ids))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ids_t = torch.from_numpy(ids).long()
    got = llama_for_causal_lm(tp, ids_t, config=LlamaQuantizedConfig(**tiny, attention_chunk=32))
    naive = llama_for_causal_lm(tp, ids_t, config=LlamaQuantizedConfig(**tiny))
    np.testing.assert_allclose(got["logits"].numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["logits"].numpy(), naive["logits"].numpy(), rtol=1e-4, atol=1e-4)
