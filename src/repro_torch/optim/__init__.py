from repro_torch.optim.sgd import (SGD, AdamW, AdamWState, SGDState,
                                   warmup_cosine)
from repro_torch.optim.grad_accum import accumulate_grads
from repro_torch.optim import compression

__all__ = ["SGD", "AdamW", "SGDState", "AdamWState", "warmup_cosine",
           "accumulate_grads", "compression"]
