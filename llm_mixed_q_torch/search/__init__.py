"""Mixed-precision search (counterpart of the JAX package's ``search/``):
the categorical search engine and its five samplers, the per-arch quant
config samplers, and the GLUE and prompting searches, plain and
conditional (integer widths with fractional widths from a stat profile)."""

from .conditional import SearchIntQuantisationForClassification
from .engine import (
    SAMPLER_MAP,
    FrozenTrial,
    Study,
    Trial,
    create_study,
    get_sampler,
    non_dominated_sort,
)
from .prompting import (
    SearchIntQuantisationForPromptingCLS,
    SearchQuantisationForPromptingCLS,
)
from .samplers_model import MODEL_SAMPLER_MAP, get_model_sampler
from .search import SearchBase, SearchQuantisationForClassification
