"""Launchers of the port (``repro.launch`` in the reference): the edge
serving launcher, :mod:`repro_torch.launch.serve`, the trainer, the
serving and training steps, and the device meshes of the closed loop's
mesh paths, :mod:`repro_torch.launch.mesh`."""
