from repro_torch.kernels.ssd_scan.ops import SSDScanFn, ssd, ssd_step
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_ref

__all__ = ["ssd", "ssd_step", "ssd_chunked", "ssd_ref", "SSDScanFn"]
