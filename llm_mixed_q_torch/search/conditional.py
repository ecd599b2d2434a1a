"""Conditional (integer) search: sample widths, derive frac widths from
statistics (counterpart of the JAX package's ``search/conditional.py``;
reference search_conditional.py:96-683,
``SearchIntQuantisationForClassification``). A trial samples only widths
from the seed, flattens them, derives each node's fractional width from
the pre-collected stat profile
(``transform_stat_profile_to_int_quant_config``), and the arch's stat
formatter adds the matmul / rope nodes before the eval.
"""

from __future__ import annotations

import logging

from ..config.stat_to_int import transform_stat_profile_to_int_quant_config
from ..models import get_stat_config_formatter
from ..utils.dict_tools import flatten_dict
from .search import SearchQuantisationForClassification

logger = logging.getLogger(__name__)


class SearchIntQuantisationForClassification(SearchQuantisationForClassification):
    def __init__(
        self,
        model_arch: str,
        model_name: str,
        search_config,
        save_dir,
        params: dict,
        stat_profile: dict,
        range_entry: str = "range_min_max",
        num_labels: int = 2,
        model_config_kwargs: dict | None = None,
    ):
        super().__init__(
            model_arch,
            model_name,
            search_config,
            save_dir,
            params,
            num_labels,
            model_config_kwargs,
        )
        self.stat_profile = stat_profile
        self.range_entry = range_entry
        self.q_config_formatter = get_stat_config_formatter(model_arch)

    def _sampled_to_config(self, sampled: dict, num_layers: int) -> dict:
        """parsed sampled widths + stat profile -> complete integer config
        (reference search_conditional.py:262-285): flatten_dict produces keys
        like ``root:model_layer_0:self_attn:q_proj:data_in_width``, exactly
        what the transform looks up per stat-profile entry name."""
        sampled = self.q_config_parser(sampled, num_layers, strict=False)
        sampled_flat: dict = {}
        flatten_dict(sampled, new_d=sampled_flat, name="root")
        config = transform_stat_profile_to_int_quant_config(
            self.stat_profile,
            range_entry=self.range_entry,
            width=sampled_flat,
            frac_choices=None,
            root_name="root",
            is_ptq=True,
            bypass=False,
        )
        self.q_config_formatter(
            config,
            num_layers,
            default_config=sampled,
            is_ptq=True,
            bypass=False,
        )
        return config

    def _trial_config(self, sampled: dict, num_layers: int) -> dict:
        config = self._sampled_to_config(sampled, num_layers)
        return self.q_config_parser(config, num_layers, strict=False)
