"""PyTorch/CUDA port of the adaptive-shrinking SMO SVM (``repro``) and of
its LM substrate's serving path.

Same module layout as the JAX package (``core/``, ``kernels/``, ``data/``,
``models/``, ``configs/``, ``launch/``) so each module's counterpart is
easy to find. Imports ``torch`` only — never ``jax`` and nothing of
``repro``. The eight kernels of the dense and sparse (block-ELL / CSR)
SVM training and serving paths and of LM prefill (flash attention) are
hand-written CUDA for Hopper (``kernels/csrc/*.cu``), built with ``nvcc``
at first use; on CPU tensors each kernel wrapper runs its plain PyTorch
version (``kernels/ref.py``).

Library boundaries: ``from repro_torch.core import train`` (SVM) and
``repro_torch.launch.serve.generate`` (LM serving).
"""
