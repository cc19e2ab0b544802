"""Training: LoRA (QLoRA over a quantized base) and full fine-tuning
(counterpart of ``llama32mm_tpu/train``); ``train/data.py`` (packing,
resumable iteration, prefetch) and the ``train/finetune.py`` command line
beside them."""

from llama32mm_tpu_torch.train.accum import accumulate_grads, valid_target_count
from llama32mm_tpu_torch.train.full import (
    FullTrainState,
    load_full_train_state,
    make_optimizer,
    make_train_step,
    save_full_train_state,
    split_trainable,
)
from llama32mm_tpu_torch.train.lora import (
    Linear_LORA,
    gather_adapter_bank,
    init_lora_params,
    load_lora_adapters,
    load_train_state,
    lora_train_step,
    make_lora_train_step,
    merge_lora_into_params,
    save_lora_adapters,
    save_train_state,
    stack_adapter_bank,
    zero_lora_params,
)

__all__ = [
    "accumulate_grads",
    "valid_target_count",
    "FullTrainState",
    "load_full_train_state",
    "make_optimizer",
    "make_train_step",
    "save_full_train_state",
    "split_trainable",
    "Linear_LORA",
    "gather_adapter_bank",
    "init_lora_params",
    "load_lora_adapters",
    "load_train_state",
    "lora_train_step",
    "make_lora_train_step",
    "merge_lora_into_params",
    "save_lora_adapters",
    "save_train_state",
    "stack_adapter_bank",
    "zero_lora_params",
]
