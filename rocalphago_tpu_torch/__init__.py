"""PyTorch/CUDA port of ``rocalphago_tpu``.

A second package beside the JAX reference. It imports ``torch`` and
never ``jax``, ``flax`` or anything of ``rocalphago_tpu``: host
modules it needs (the rules oracle, the Zobrist tables, the feature
names) are copied, not imported. Every Pallas kernel of the reference
that lies on a ported path has a hand-written CUDA C++ twin under
``csrc/``, built at first use by :mod:`.ops._build`.

Entry points (model loading, :class:`~.features.api.Preprocess`, the
GTP ``main``) run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit CPU request they raise
(:func:`resolve_device`).
"""

from rocalphago_tpu_torch.device import resolve_device  # noqa: F401
