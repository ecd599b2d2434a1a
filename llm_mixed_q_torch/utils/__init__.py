from .toml_io import convert_str_na_to_none, load_config
