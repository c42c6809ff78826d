"""Go rules engines: the host oracle :mod:`.pygo` and the batched
tensor engine :mod:`.torchgo`."""

from rocalphago_tpu_torch.engine.pygo import (  # noqa: F401
    BLACK,
    EMPTY,
    PASS_MOVE,
    WHITE,
    GameState,
)
