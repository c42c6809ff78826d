"""PyTorch/CUDA port of ``rocalphago_tpu``.

A second package beside the JAX reference. It imports ``torch`` and
never ``jax``, ``flax`` or anything of ``rocalphago_tpu``: host
modules it needs (the rules oracle, the Zobrist tables, the feature
names, the move clock and deadline) are copied, not imported. Every
Pallas kernel of the reference that lies on a ported path has a
hand-written CUDA C++ twin under ``csrc/``, built at first use by
:mod:`.ops._build`; so do the device search's two tree walks, which the
reference runs as ``lax.while_loop``s.

Entry points (model loading, :class:`~.features.api.Preprocess`, the
GTP ``main``) run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit CPU request they raise
(:func:`resolve_device`).

Importing the package itself loads no torch (``resolve_device`` is
resolved on first use), so the host-only modules -- the replay wire
and its synthetic actor among them -- start without it.
"""


def __getattr__(name):
    if name == "resolve_device":
        from rocalphago_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
