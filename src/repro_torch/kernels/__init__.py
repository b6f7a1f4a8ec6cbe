"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Importing this package builds nothing: the CUDA library is compiled at the
first launch (see :mod:`repro_torch.kernels.build`).
"""
