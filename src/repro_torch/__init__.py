"""Lightning in PyTorch and CUDA for an NVIDIA H100.

The counterpart of the ``repro`` package, module for module: annotated
kernel launches (``core``), hand-written Hopper kernels (``kernels`` with
their CUDA C++ sources under ``csrc``), observability (``obs``) and the
conversion door for state handed over as numpy arrays (``convert``).

Entry points run on the card unless the caller names another device.
"""

__version__ = "0.1.0"
