"""Runnable examples of the port, twins of the reference's ``examples/``
and of its ``benchmarks/tables.py`` (the paper's Tables 1-2):

* :mod:`~repro_torch.examples.quickstart` — plan MobileNet v1, then trace
  any PyTorch function, plan it and run it out of one arena;
* :mod:`~repro_torch.examples.dynamic_shapes` — the paper's §7 staged
  planning with tensors whose sizes become known late;
* :mod:`~repro_torch.examples.paper_tables` — Tables 1 and 2 beside the
  published numbers, and the paper's claims checked;
* :mod:`~repro_torch.examples.serve_lm` and
  :mod:`~repro_torch.examples.train_lm` — the serving and training entry
  points.

Each runs as ``python -m repro_torch.examples.<name>``; those that touch a
device run on the card unless given ``--device cpu``.
"""
