"""The towers: the LLaMA decoder, the ViT and the VLM that joins them."""

from llama32mm_tpu_torch.models.language import (
    causal_lm_forward,
    init_causal_lm_params,
    init_llama_params,
    llama_forward,
    lm_head_apply,
    prepare_attention_mask,
    prepare_position_ids,
)
from llama32mm_tpu_torch.models.vision import init_vision_params, patchify, vision_encoder_forward
from llama32mm_tpu_torch.models.vlm import (
    VLMOutput,
    encode_image,
    init_vlm,
    merge_input_ids_with_image_features,
    shifted_cross_entropy,
    vlm_forward,
)

init_vlm_params = init_vlm  # the JAX package's name

__all__ = [
    "causal_lm_forward",
    "init_causal_lm_params",
    "init_llama_params",
    "llama_forward",
    "lm_head_apply",
    "prepare_attention_mask",
    "prepare_position_ids",
    "init_vision_params",
    "patchify",
    "vision_encoder_forward",
    "VLMOutput",
    "encode_image",
    "init_vlm_params",
    "merge_input_ids_with_image_features",
    "shifted_cross_entropy",
    "vlm_forward",
]
