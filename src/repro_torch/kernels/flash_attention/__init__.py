from repro_torch.kernels.flash_attention.ops import (FlashAttentionFn,
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_bwd)

__all__ = ["flash_attention", "attention_ref", "flash_attention_bwd",
           "FlashAttentionFn"]
