"""PyTorch/CUDA port of the ``repro`` package.

Runs beside ``repro`` (the JAX reference) and imports nothing of it: the
modules it needs from ``repro`` are copied here with their imports renamed.
Every Pallas kernel on a ported path has a hand-written CUDA counterpart
under ``kernels/csrc``; each kernel package keeps a plain PyTorch version
in its ``ref.py`` for the CPU and for comparison.
"""
