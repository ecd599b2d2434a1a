"""OPT model configuration (counterpart of the JAX package's
``models/opt/configuration.py``). A ``quant_config`` given as a TOML path or
an unexpanded dict is expanded per layer in ``__post_init__``."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from .quant_config import parse_opt_quantized_config


@dataclass
class OPTQuantizedConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    num_hidden_layers: int = 12
    ffn_dim: int = 3072
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    word_embed_proj_dim: int | None = None
    do_layer_norm_before: bool = True
    enable_bias: bool = True
    layer_norm_elementwise_affine: bool = True
    activation_function: str = "relu"
    pad_token_id: int = 1
    bos_token_id: int = 2
    eos_token_id: int = 2
    num_labels: int = 2
    tie_word_embeddings: bool = True
    quant_config: dict | str | None = None
    model_type: str = "opt"
    problem_type: str | None = None

    def __post_init__(self):
        if self.word_embed_proj_dim is None:
            self.word_embed_proj_dim = self.hidden_size
        if self.quant_config is not None and not (
            isinstance(self.quant_config, dict) and "model_layer_0" in self.quant_config
        ):
            self.quant_config = parse_opt_quantized_config(self.quant_config,
                                                           self.num_hidden_layers)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_config(cls, hf_config, quant_config=None, **overrides):
        """Build from a transformers OPTConfig instance or dict."""
        if not isinstance(hf_config, dict):
            hf_config = hf_config.to_dict()
        kwargs = {}
        for f_ in (
            "vocab_size hidden_size num_hidden_layers ffn_dim num_attention_heads "
            "max_position_embeddings word_embed_proj_dim do_layer_norm_before "
            "enable_bias layer_norm_elementwise_affine activation_function "
            "pad_token_id bos_token_id eos_token_id tie_word_embeddings"
        ).split():
            if hf_config.get(f_) is not None:
                kwargs[f_] = hf_config[f_]
        kwargs.update(overrides)
        return cls(quant_config=quant_config, **kwargs)

    @classmethod
    def from_pretrained(cls, model_dir: str | Path, quant_config=None, **overrides):
        """From the ``config.json`` of a local model directory."""
        with open(Path(model_dir) / "config.json") as f:
            hf = json.load(f)
        return cls.from_hf_config(hf, quant_config=quant_config, **overrides)
