from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                 restore_global_tier,
                                                 save_global_tier)

__all__ = ["Checkpointer", "save_global_tier", "restore_global_tier"]
