"""Hand-written Hopper kernels of the port and their plain versions.

``csrc/*.cu`` holds the CUDA sources, ``cuda.py`` builds and loads them
(and counts launches), ``gamma_update.py`` / ``rbf_row.py`` /
``sparse_ell.py`` launch them,
``ref.py`` holds the plain PyTorch versions and ``ops.py`` dispatches
between the two by tensor device.
"""
