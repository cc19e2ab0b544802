"""Prompt templating and the tokenizer wrapper (counterpart of
``llama32mm_tpu/preprocess/processor.py``), the reference's
``MllamaImageProcessor``:

- adds ``<image>`` as an additional special token plus 128 ``<seg###>``
  extra tokens (the reference builds 1024 ``<loc####>`` tokens and
  overwrites that list with the seg tokens at once, so only the seg tokens
  are added);
- turns the tokenizer's auto-BOS and auto-EOS off;
- prompt template ``"<image>" * image_seq_len + bos + prompt + "\\n"``
  (placeholders *before* the BOS);
- ``__call__(text, images, padding, truncation)`` asserts one image and one
  prompt and returns pixel values (the host pipeline, numpy) and the
  tokenized ids and mask, under ``"pixel_values"`` and the reference's
  ``"pixel_value"`` alias.

PIL is imported only where an image is resized (``_bicubic``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from llama32mm_tpu_torch.preprocess.image import (
    IMAGENET_STANDARD_MEAN,
    IMAGENET_STANDARD_STD,
    process_images,
)


def add_image_tokens_to_prompts(prefix_prompt, bos_token, image_seq_len, image_token):
    """The reference's prompt template."""
    return f"{image_token * image_seq_len}{bos_token}{prefix_prompt}\n"


class MllamaImageProcessor:
    IMAGE_TOKEN = "<image>"

    def __init__(self, tokenizer, num_image_token: int, image_size: int):
        self.image_seq_length = num_image_token
        self.image_size = image_size

        tokenizer.add_special_tokens({"additional_special_tokens": [self.IMAGE_TOKEN]})
        extra_tokens = [f"<seg{i:03d}>" for i in range(128)]
        tokenizer.add_tokens(extra_tokens)
        self.image_token_id = tokenizer.convert_tokens_to_ids(self.IMAGE_TOKEN)

        tokenizer.add_bos_token = False
        tokenizer.add_eos_token = False
        self.tokenizer = tokenizer

    def __call__(self, text: List[str], images: List, padding, truncation: bool = True):
        assert len(images) == 1 and len(text) == 1, (
            f"Received {len(images)} images for {len(text)} prompts"
        )
        pixel_values = process_images(
            images,
            size=(self.image_size, self.image_size),
            resample=_bicubic(),
            rescale_factor=1 / 255.0,
            image_mean=IMAGENET_STANDARD_MEAN,
            image_std=IMAGENET_STANDARD_STD,
        )
        pixel_values = np.stack(pixel_values, axis=0)

        input_strings = [
            add_image_tokens_to_prompts(
                prefix_prompt=prompt,
                bos_token=self.tokenizer.bos_token,
                image_seq_len=self.image_seq_length,
                image_token=self.IMAGE_TOKEN,
            )
            for prompt in text
        ]
        inputs = self.tokenizer(
            input_strings, return_tensors="np", padding=padding, truncation=truncation
        )
        return {
            "pixel_values": pixel_values,
            "pixel_value": pixel_values,  # the reference's key
            **inputs,
        }


def _bicubic():
    from PIL import Image

    return Image.Resampling.BICUBIC
