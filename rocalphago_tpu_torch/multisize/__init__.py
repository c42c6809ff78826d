"""Multi-size serving: one net, every board (the port of the reference
package's ``multisize/``). :class:`~.pool.MultiSizePool` shares the
weights across one :class:`~rocalphago_tpu_torch.serve.sessions.
ServePool` per size and routes sessions by requested size; GTP
``boardsize`` on a multi-size engine (``--serve-sizes``) re-routes the
session instead of refusing the size."""

from rocalphago_tpu_torch.multisize.pool import (  # noqa: F401
    DEFAULT_SIZES,
    MultiSizePool,
)
