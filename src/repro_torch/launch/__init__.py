"""Entry points of the LM zoo (``python -m repro_torch.launch.serve``)."""
