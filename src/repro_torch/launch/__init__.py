"""Entry points of the port (twin of ``repro.launch``): the LM serving
steps (``train_lib``) and the serving CLI (``serve``)."""
