"""Launchers of the port (``repro.launch`` in the reference): the edge
serving launcher, :mod:`repro_torch.launch.serve`."""
