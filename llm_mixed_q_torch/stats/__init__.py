from .capture import PARAM_PATH_SPECS, TAP_ENTRY_SPECS, StatTapRouter, make_tapped_forward
from .manager import ActStatCollection, StatManager, WeightStatCollection
from .profiler import DEFAULT_ACT_STATS, DEFAULT_WEIGHT_STATS, profile_statistics
from .stats import STAT_NAME_TO_CLS, create_new_stat
