"""PyTorch/CUDA port of the adaptive-shrinking SMO SVM (``repro``).

Same module layout as the JAX package (``core/``, ``kernels/``, ``data/``)
so each module's counterpart is easy to find. Imports ``torch`` only —
never ``jax`` and nothing of ``repro``. The seven kernels of the dense
and sparse (block-ELL / CSR) training and serving paths are hand-written
CUDA for Hopper (``kernels/csrc/*.cu``), built with ``nvcc`` at first use;
on CPU tensors each kernel wrapper runs its plain PyTorch version
(``kernels/ref.py``).

Library boundary: ``from repro_torch.core import train``.
"""
