"""Entry points of the port (twin of ``repro.launch``): the LM train,
prefill and decode steps (``train_lib``), LM training (``train``), the
serving CLI (``serve``), process groups
(``dist``), elastic resume and the straggler watchdog (``elastic``), and
the chaos harness (``chaos``)."""
