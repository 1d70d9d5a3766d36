from .convert import (ernie_params_from_numpy, llama_params_from_numpy,
                      params_from_numpy, unet_params_from_numpy,
                      vision_params_from_numpy, vit_params_from_numpy)
from .ernie import (ErnieConfig, ErnieForMaskedLM,
                    ErnieForSequenceClassification, ErnieModel,
                    ernie_config_base, ernie_config_tiny)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    build_functional_llama, build_llama_paged_decode,
                    functional_params_from_layer, init_llama_params,
                    llama_config_7b, llama_config_tiny,
                    make_paged_decode_horizon)
from .unet import (UNet2DConditionModel, UNetConfig, timestep_embedding,
                   unet_config_sd15, unet_config_tiny)

__all__ = ["ErnieConfig", "ErnieForMaskedLM",
           "ErnieForSequenceClassification", "ErnieModel", "LlamaConfig",
           "LlamaForCausalLM", "LlamaModel", "functional_params_from_layer",
           "llama_params_from_numpy",
           "build_functional_llama", "build_llama_paged_decode",
           "ernie_config_base", "ernie_config_tiny", "ernie_params_from_numpy",
           "init_llama_params", "llama_config_7b", "llama_config_tiny",
           "make_paged_decode_horizon", "params_from_numpy",
           "timestep_embedding", "UNet2DConditionModel", "UNetConfig",
           "unet_config_sd15", "unet_config_tiny", "unet_params_from_numpy",
           "vision_params_from_numpy", "vit_params_from_numpy"]
