"""The object API (counterpart of ``llama32mm_tpu/models/wrapper.py``): the
reference's ``Llama3Model``, ``Llama3ForCausalLM`` and
``MllamaForConditionalGeneration`` constructors, ``(config, params=None,
seed=0, device)``.

The port's models already are ``nn.Module``s whose ``forward`` is the
functional forward (``models/language.py``, ``models/vlm.py``); these
classes add only the reference's constructors and helpers on top of them:

- ``params=None``: random weights from ``seed`` on an explicit
  ``torch.Generator`` on ``device``, the JAX package's distributions, with
  an untied head (the JAX wrappers init with ``tie_weights=False``);
- ``params``: a port module of the same kind (its tensors are shared, not
  copied), or the JAX package's parameter tree as nested dicts of numpy
  arrays (converted by ``convert.py``);
- ``device`` defaults to ``cuda``.

Calls return the JAX wrappers' shapes: ``Llama3Model`` a ``LlamaOutput
(hidden_states, kv_cache)``, ``Llama3ForCausalLM`` ``(logits, kv_cache)``,
the VLM the dict ``{"logits", "loss", "hidden_states", "kv_cache"}``.
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from llama32mm_tpu_torch.configs import LLAMA32Config, MLLAMAConfig
from llama32mm_tpu_torch.models.common import copy_module
from llama32mm_tpu_torch.models.language import CausalLM, LlamaModel
from llama32mm_tpu_torch.models.vlm import MllamaForConditionalGeneration as _VLM
from llama32mm_tpu_torch.models.vlm import init_vlm


def _adopt(self: nn.Module, src: nn.Module) -> None:
    """Make ``self`` hold ``src``'s submodules, tensors and attributes."""
    nn.Module.__init__(self)
    self.__dict__.update(copy_module(src).__dict__)


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class Llama3Model(LlamaModel):
    """The reference's ``Llama3Model``: embeddings → blocks → final norm, no
    head. ``forward`` returns ``LlamaOutput(hidden_states, kv_cache)``."""

    def __init__(self, config: LLAMA32Config, params: Union[LlamaModel, dict, None] = None,
                 seed: int = 0, device="cuda"):
        if params is None:
            params = LlamaModel(config, device, config.torch_dtype)
            with torch.no_grad():
                params.init_(_gen(device, seed))
        elif isinstance(params, dict):  # the JAX package's init_llama_params tree
            from llama32mm_tpu_torch.convert import causal_lm_from_jax

            tree = {"model": params, "lm_head": {"weight": None}}
            params = causal_lm_from_jax(tree, config, device).model
        _adopt(self, params)


class Llama3ForCausalLM(CausalLM):
    """The reference's ``Llama3ForCausalLM``: ``forward`` returns
    ``(logits, kv_cache)``."""

    def __init__(self, config: LLAMA32Config, params: Union[CausalLM, dict, None] = None,
                 seed: int = 0, device="cuda"):
        if params is None:
            params = CausalLM(config, device, config.torch_dtype, tie_weights=False)
            with torch.no_grad():
                params.init_(_gen(device, seed))
        elif isinstance(params, dict):  # the JAX package's init_causal_lm_params tree
            from llama32mm_tpu_torch.convert import causal_lm_from_jax

            params = causal_lm_from_jax(params, config, device)
        _adopt(self, params)

    def tie_weights(self) -> None:
        """Tie the head to the embedding (the reference's ``tie_weights``):
        the head then reads ``tok_emb`` and ``lm_head`` is None."""
        self.lm_head = None


class MllamaForConditionalGeneration(_VLM):
    """The reference's ``MllamaForConditionalGeneration``: ``forward``
    returns ``{"logits", "loss", "hidden_states", "kv_cache"}``."""

    def __init__(self, config: MLLAMAConfig, params: Union[_VLM, dict, None] = None,
                 seed: int = 0, device="cuda"):
        if params is None:
            params = init_vlm(config, device, _gen(device, seed), tie_weights=False)
        elif isinstance(params, dict):  # the JAX package's init_vlm_params tree
            from llama32mm_tpu_torch.convert import from_jax_params

            params = from_jax_params(params, config, device)
        _adopt(self, params)
        self.text_config = config.text_config
        self.vision_config = config.vision_config
        self.vocab_size = config.vocab_size
        self.ignore_index = config.ignore_index
        self.image_token_index = config.image_token_index

    def tie_weights(self) -> None:
        """Tie the head to the embedding; the ``language_model`` that
        ``params`` shared is left as it was."""
        self.language_model = copy_module(self.language_model)
        self.language_model.lm_head = None

    def get_input_embeddings(self) -> nn.Parameter:
        """The ``[vocab, hidden]`` embedding table."""
        return self.language_model.model.tok_emb


__all__ = ["Llama3ForCausalLM", "Llama3Model", "MllamaForConditionalGeneration"]
