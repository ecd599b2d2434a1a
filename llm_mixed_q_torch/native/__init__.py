"""The host tier of the port: its own copy of the JAX package's C++ BFP
pack engine (``bfp_pack.cc``), built with g++ at first use and loaded
through ctypes. It packs weights on the host, so that only packed bytes
cross to the card (``pack_llama_params_host``)."""

from .loader import (
    native_available,
    native_calls,
    native_pack_int8,
    native_pack_subbyte,
    reset_native_calls,
)

__all__ = ["native_available", "native_calls", "native_pack_int8", "native_pack_subbyte",
           "reset_native_calls"]
