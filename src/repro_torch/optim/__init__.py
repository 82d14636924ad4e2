"""Optimizers of the port (twin of ``repro.optim``): AdamW. The reference's
``compress`` codecs act only over a multi-pod mesh and come with the mesh
and sharding slice."""
