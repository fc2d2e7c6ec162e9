"""The port's kernels.  Each package holds the wrapper (``ops.py``) and the
plain PyTorch version (``ref.py``); the CUDA sources are in ``csrc/`` and
are built at first use by :mod:`repro_torch.kernels._build`."""
