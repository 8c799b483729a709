"""repro_torch.launch — command-line entry points of the port
(``python -m repro_torch.launch.train``)."""
