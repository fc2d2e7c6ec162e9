from repro_torch.kernels.moe_gmm.ops import gmm
from repro_torch.kernels.moe_gmm.ref import gmm_ref

__all__ = ["gmm", "gmm_ref"]
