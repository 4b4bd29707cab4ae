"""paddle_tpu_torch.lora (port of paddle_tpu/lora): batched LoRA
adapters.  Train rank-r fine-tunes on a frozen base, export them as
sha-verified artifacts (the reference's format), and serve many of them on
one base model, each slot with its own adapter id as an input of the
unchanged captured program family.

Train:   apply_lora(model, rank=8) -> train (only the factors move)
         export_adapter(model, "tenant_a.npz")
Serve:   eng = ServingEngine(model, lora=LoRAConfig(rank=8,
                                                    max_adapters=8))
         eng.load_adapter("tenant_a", "tenant_a.npz")
         eng.submit(prompt, 32, adapter="tenant_a")
"""
from .layers import (DEFAULT_TARGETS, LoRALinear, LoRAWrapper,  # noqa: F401
                     adapter_context, apply_lora, attach_serving_lora,
                     lora_keys)
from .train import (ADAPTER_VERSION, AdapterIntegrityError,  # noqa: F401
                    base_weights_hash, export_adapter, load_adapter,
                    read_adapter)
from .registry import (AdapterExhaustedError,  # noqa: F401
                       AdapterNotFoundError,
                       AdapterRegistry, LoRAConfig)

__all__ = [
    "LoRALinear", "LoRAWrapper", "apply_lora", "DEFAULT_TARGETS",
    "lora_keys", "adapter_context", "attach_serving_lora",
    "export_adapter", "read_adapter", "load_adapter", "base_weights_hash",
    "ADAPTER_VERSION", "AdapterIntegrityError",
    "LoRAConfig", "AdapterRegistry", "AdapterNotFoundError",
    "AdapterExhaustedError",
]
