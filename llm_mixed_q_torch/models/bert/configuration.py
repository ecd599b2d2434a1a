"""BERT model configuration (counterpart of the JAX package's
``models/bert/configuration.py``). A ``quant_config`` given as a TOML path
or an unexpanded dict is expanded per layer in ``__post_init__``."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from .quant_config import parse_bert_quantized_config


@dataclass
class BertQuantizedConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    position_embedding_type: str = "absolute"
    num_labels: int = 2
    classifier_dropout: float | None = None
    quant_config: dict | str | None = None
    model_type: str = "bert"
    problem_type: str | None = None

    def __post_init__(self):
        if self.quant_config is not None and not (
            isinstance(self.quant_config, dict) and "model_layer_0" in self.quant_config
        ):
            self.quant_config = parse_bert_quantized_config(self.quant_config,
                                                            self.num_hidden_layers)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_config(cls, hf_config, quant_config=None, **overrides):
        """Build from a transformers BertConfig instance or dict."""
        if not isinstance(hf_config, dict):
            hf_config = hf_config.to_dict()
        kwargs = {}
        for f_ in (
            "vocab_size hidden_size num_hidden_layers num_attention_heads "
            "intermediate_size hidden_act max_position_embeddings type_vocab_size "
            "layer_norm_eps pad_token_id position_embedding_type classifier_dropout"
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
