from .dict_tools import expand_dict, flatten_dict
from .logger import get_logger, set_logging_verbosity
from .toml_io import (
    convert_none_to_str_na,
    convert_str_na_to_none,
    dumps_toml,
    load_config,
    save_config,
)
