"""Fused two-tier state push: kernels K1–K4 and their plain versions.

Counterpart of ``repro.kernels.state_push``.  ``hostcodec`` is the numpy
host wire codec (imports no torch); ``ops`` holds the wrappers over the
CUDA kernels in ``kernels/csrc/state_push.cu`` and ``ref`` the plain
PyTorch versions.
"""
from repro_torch.kernels.state_push.ops import (apply_delta, apply_pull,
                                                dequantize, encode_fp8,
                                                encode_pull, encode_quant,
                                                push, quantize_delta,
                                                wire_nbytes)
from repro_torch.kernels.state_push.ref import (apply_delta_ref, push_ref,
                                                quantize_delta_ref,
                                                quantize_fp8_ref)

__all__ = ["apply_delta", "apply_pull", "dequantize", "encode_fp8",
           "encode_pull", "encode_quant", "push", "quantize_delta",
           "wire_nbytes", "apply_delta_ref", "push_ref", "quantize_delta_ref",
           "quantize_fp8_ref"]
