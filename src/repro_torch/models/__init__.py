"""LM substrate of the port (twin of ``repro.models``): ``api`` (config and
family registry), ``common`` (norms, RoPE, attention, MLP, init) and
``transformer`` (the dense decoder: init, forward, KV-cache decode)."""
