"""Entry points of the port (twin of ``repro.launch``): the LM serving
steps (``train_lib``), the serving CLI (``serve``), process groups
(``dist``), elastic resume and the straggler watchdog (``elastic``), and
the chaos harness (``chaos``)."""
