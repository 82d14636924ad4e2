"""Checkpoints of the port (twin of ``repro.ckpt``): atomic step
directories of host arrays, readable by both packages."""
