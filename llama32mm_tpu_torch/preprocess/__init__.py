from llama32mm_tpu_torch.preprocess.image import (
    IMAGENET_STANDARD_MEAN,
    IMAGENET_STANDARD_STD,
    normalize,
    preprocess_image_device,
    process_images,
    rescale,
    resize,
)
from llama32mm_tpu_torch.preprocess.processor import (
    MllamaImageProcessor,
    add_image_tokens_to_prompts,
)

__all__ = [
    "IMAGENET_STANDARD_MEAN",
    "IMAGENET_STANDARD_STD",
    "normalize",
    "preprocess_image_device",
    "process_images",
    "rescale",
    "resize",
    "MllamaImageProcessor",
    "add_image_tokens_to_prompts",
]
