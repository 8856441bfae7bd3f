"""PyTorch/CUDA port of the ``repro`` selection engine (Beliakov 2011).

Exact median and order statistics on an NVIDIA H100, with the data passes
in hand-written CUDA kernels (``kernels/csrc``) and everything else in
plain PyTorch.  Entry points compute on the device of the tensor they are
given; :func:`repro_torch.convert.from_numpy` places input on the card
unless told otherwise.  Imports neither JAX nor the ``repro`` package.
"""
