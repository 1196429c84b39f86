"""The example CLIs, over the port's entry points: ``python -m
repro_torch.examples.<name>`` with ``quickstart``, ``train_agent``,
``serve_gdm`` and ``serve_fleet``.  Each keeps its reference's flags and
defaults (``examples/*.py``) and adds ``--device`` (the card unless
given).  The reference's ``serve_edge.py`` and ``train_lm.py`` map to
``repro_torch.launch.serve`` and ``repro_torch.launch.train``.
"""
