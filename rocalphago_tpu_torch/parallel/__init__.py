"""Data parallelism over ``torch.distributed``: :mod:`.mesh` (the
reference's ``parallel/mesh.py``) and :mod:`.launch` (ranks spawned as
child processes over a file store)."""
