from .convert import params_from_numpy
from .llama import (LlamaConfig, build_functional_llama,
                    build_llama_paged_decode, init_llama_params,
                    llama_config_7b, llama_config_tiny,
                    make_paged_decode_horizon)

__all__ = ["LlamaConfig", "build_functional_llama",
           "build_llama_paged_decode", "init_llama_params",
           "llama_config_7b", "llama_config_tiny", "make_paged_decode_horizon",
           "params_from_numpy"]
