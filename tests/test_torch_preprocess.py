"""The port's image preprocessing and prompt processor against the JAX
package's: ``preprocess_image_device`` with its resize against
``jax.image.resize(method="cubic")`` at downscales, upscales and
non-square shapes (``F.interpolate``'s antialiased bicubic as a second
witness), the host pipeline and ``MllamaImageProcessor`` with the JAX
tests' ``FakeTokenizer`` pattern and the trained ``tests/assets/
tiny_tokenizer``. Seeded numpy images, CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from llama32mm_tpu.preprocess import image as jimage
from llama32mm_tpu.preprocess import processor as jprocessor
from llama32mm_tpu_torch.preprocess import image, processor
from llama32mm_tpu_torch.preprocess.image import cubic_resize, preprocess_image_device

ASSET = os.path.join(os.path.dirname(__file__), "assets", "tiny_tokenizer")

# (batch, height, width, image_size): downscales, upscales, non-square, tiny
RESIZES = [
    (1, 1120, 840, 560), (1, 2000, 3000, 560), (1, 28, 100, 28), (2, 30, 28, 28),
    (1, 300, 400, 560), (1, 560, 300, 560), (1, 1, 1, 28), (1, 3, 5, 28),
    (1, 3024, 4032, 560),
]


@pytest.mark.parametrize("b,h,w,size", RESIZES)
def test_preprocess_with_resize_matches_jax(b, h, w, size):
    """Within 1e-4 of JAX after normalisation. On the 0-255 scale the
    resize alone stays within 5e-3 of JAX's and of ``F.interpolate``'s
    antialiased bicubic (Keys a = -0.5), and, like both, is not clamped."""
    raw = np.random.RandomState(h * w).randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    want = np.asarray(jimage.preprocess_image_device(jnp.asarray(raw), size))
    got = preprocess_image_device(torch.from_numpy(raw), size)
    assert got.shape == (b, 3, size, size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)

    x = torch.from_numpy(raw).float()
    resized = cubic_resize(x, size, size).numpy()
    jax_resized = np.asarray(jax.image.resize(
        jnp.asarray(raw, jnp.float32), (b, size, size, 3), method="cubic"))
    interp = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bicubic",
                           antialias=True, align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(resized, jax_resized, rtol=0, atol=5e-3)
    np.testing.assert_allclose(resized, interp, rtol=0, atol=5e-3)
    if (h, w) == (3, 5):  # a cubic overshoots near sharp edges, on both sides
        assert resized.min() < 0 and resized.max() > 255
        assert jax_resized.min() < 0 and jax_resized.max() > 255


def test_preprocess_without_resize_and_bad_rank():
    raw = np.random.RandomState(1).randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    want = np.asarray(jimage.preprocess_image_device(jnp.asarray(raw), 16))
    got = preprocess_image_device(torch.from_numpy(raw), 16, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)
    with pytest.raises(ValueError, match=r"\[B, H, W, C\]"):
        preprocess_image_device(torch.zeros(16, 16, 3, dtype=torch.uint8), 16)


def _pil_image(h=40, w=30, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("size", [(16, 16), (28, 20)])
def test_host_pipeline_matches_jax(size):
    from PIL import Image

    kw = dict(size=size, resample=Image.Resampling.BICUBIC, rescale_factor=1 / 255.0,
              image_mean=image.IMAGENET_STANDARD_MEAN, image_std=image.IMAGENET_STANDARD_STD)
    got = image.process_images([_pil_image()], **kw)
    want = jimage.process_images([_pil_image()], **kw)
    assert len(got) == 1 and got[0].shape == (3,) + size and got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    img = np.full((2, 2, 3), 255, np.uint8)
    np.testing.assert_array_equal(image.rescale(img, 1 / 255.0), jimage.rescale(img, 1 / 255.0))
    r = image.rescale(img, 1 / 255.0)
    np.testing.assert_array_equal(
        image.normalize(r, image.IMAGENET_STANDARD_MEAN, image.IMAGENET_STANDARD_STD),
        jimage.normalize(r, jimage.IMAGENET_STANDARD_MEAN, jimage.IMAGENET_STANDARD_STD))


class FakeTokenizer:
    """The JAX tests' tokenizer double: the interface the processor uses."""

    bos_token = "<bos>"
    eos_token_id = 2

    def __init__(self):
        self.vocab = {"<bos>": 1}
        self.added = []
        self.add_bos_token = True
        self.add_eos_token = True

    def add_special_tokens(self, d):
        for t in d.get("additional_special_tokens", []):
            self.vocab.setdefault(t, 100 + len(self.added))
            self.added.append(t)

    def add_tokens(self, toks):
        for t in toks:
            self.vocab.setdefault(t, 1000 + len(self.vocab))
            self.added.append(t)

    def convert_tokens_to_ids(self, t):
        return self.vocab.get(t, 0)

    def __call__(self, strings, return_tensors, padding, truncation):
        ids_batch = []
        for s in strings:
            ids, i = [], 0
            while i < len(s):
                if s.startswith("<image>", i):
                    ids.append(self.vocab["<image>"])
                    i += len("<image>")
                elif s.startswith("<bos>", i):
                    ids.append(self.vocab["<bos>"])
                    i += 5
                else:
                    ids.append(ord(s[i]) % 90 + 3)
                    i += 1
            ids_batch.append(ids)
        maxlen = max(len(x) for x in ids_batch)
        arr = np.zeros((len(ids_batch), maxlen), np.int64)
        mask = np.zeros_like(arr)
        for j, ids in enumerate(ids_batch):
            arr[j, : len(ids)] = ids
            mask[j, : len(ids)] = 1
        return {"input_ids": arr, "attention_mask": mask}


def _auto_tokenizer():
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(ASSET, padding_side="right")


@pytest.mark.parametrize("tok", ["fake", "tiny_tokenizer"])
def test_processor_matches_jax(tok):
    """Tokens added (``<image>`` special, 128 ``<seg###>``, no ``<loc####>``),
    auto-BOS/EOS off, the template's ids and mask, the pixel values under
    both keys: equal to the JAX processor's on its own tokenizer."""
    make = FakeTokenizer if tok == "fake" else _auto_tokenizer
    t_port, t_jax = make(), make()
    proc = processor.MllamaImageProcessor(t_port, num_image_token=4, image_size=16)
    jproc = jprocessor.MllamaImageProcessor(t_jax, num_image_token=4, image_size=16)
    assert not t_port.add_bos_token and not t_port.add_eos_token
    assert proc.image_token_id == jproc.image_token_id
    assert t_port.convert_tokens_to_ids("<seg127>") == t_jax.convert_tokens_to_ids("<seg127>")
    got = proc(["describe this"], [_pil_image()], padding=True)
    want = jproc(["describe this"], [_pil_image()], padding=True)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert got["pixel_value"] is got["pixel_values"]
    ids = got["input_ids"][0]
    assert list(ids[:4]) == [proc.image_token_id] * 4
    assert processor.add_image_tokens_to_prompts("hi", "<bos>", 3, "<image>") == \
        jprocessor.add_image_tokens_to_prompts("hi", "<bos>", 3, "<image>")
    if tok == "fake":
        assert "<loc0000>" not in t_port.vocab
    with pytest.raises(AssertionError, match="Received 1 images for 2 prompts"):
        proc(["a", "b"], [_pil_image()], padding=True)
