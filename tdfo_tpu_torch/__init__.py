"""tdfo_tpu_torch — the PyTorch / CUDA port of ``tdfo_tpu`` for NVIDIA Hopper.

A second package beside ``tdfo_tpu`` (the JAX reference, which it never
imports).  Subpackages mirror the reference's layout (``core``, ``data``,
``models``, ``ops``, ``parallel``, ``train``, ``utils``); every module names
the reference file it ports.  Hand-written Hopper kernels live in
``ops/csrc`` (CUDA C++) with their wrappers and plain PyTorch versions in
``ops/kernels``; they are built from source at first use, never on import.
Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
