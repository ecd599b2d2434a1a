from .logger import get_logger, set_logging_verbosity
from .toml_io import convert_str_na_to_none, load_config
