"""Launchers: the serving CLI (``python -m repro_torch.launch.serve``) and
the training CLI (``python -m repro_torch.launch.train``)."""
