"""Llama model configuration (counterpart of the JAX package's
``models/llama/configuration.py``).
The reference hooks ``__setattr__`` so assigning ``quant_config`` (TOML path or
dict) auto-expands it through the per-layer parser; here the expansion happens
in ``__post_init__`` / ``from_pretrained`` — same contract, explicit.

Adds ``num_key_value_heads`` (GQA) beyond the reference's MHA-only fork so
modern Llama checkpoints load; with ``num_key_value_heads ==
num_attention_heads`` the math is identical to the reference.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from .quant_config import parse_llama_quantized_config


@dataclass
class LlamaQuantizedConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int | None = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    pad_token_id: int | None = None
    bos_token_id: int = 1
    eos_token_id: int = 2
    num_labels: int = 2
    tie_word_embeddings: bool = False
    quant_config: dict | str | None = None
    model_type: str = "llama"
    problem_type: str | None = None
    dtype: str = "float32"
    # kv-chunked two-pass attention (ops/attention.py); None holds the full
    # score matrix, as the reference does
    attention_chunk: int | None = None

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.quant_config is not None and not self._is_parsed(self.quant_config):
            self.quant_config = parse_llama_quantized_config(
                self.quant_config, self.num_hidden_layers
            )

    @staticmethod
    def _is_parsed(qc) -> bool:
        return isinstance(qc, dict) and "model_layer_0" in qc

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_config(cls, hf_config, quant_config=None, **overrides):
        """Build from a transformers LlamaConfig instance or dict."""
        if not isinstance(hf_config, dict):
            hf_config = hf_config.to_dict()
        kwargs = {}
        for f_ in (
            "vocab_size hidden_size intermediate_size num_hidden_layers "
            "num_attention_heads num_key_value_heads max_position_embeddings "
            "rms_norm_eps rope_theta pad_token_id bos_token_id eos_token_id "
            "tie_word_embeddings"
        ).split():
            if hf_config.get(f_) is not None:
                kwargs[f_] = hf_config[f_]
        kwargs.update(overrides)
        return cls(quant_config=quant_config, **kwargs)

    @classmethod
    def from_pretrained(cls, model_dir: str | Path, quant_config=None, **overrides):
        with open(Path(model_dir) / "config.json") as f:
            hf = json.load(f)
        return cls.from_hf_config(hf, quant_config=quant_config, **overrides)
