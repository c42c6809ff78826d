"""Self-play helpers: for now only :func:`sensible_mask`, which the
device search's priors read (the rest of the reference's
``search/selfplay.py`` belongs to the self-play slice)."""

from __future__ import annotations

import torch

from rocalphago_tpu_torch.engine.torchgo import (
    GoConfig,
    GoState,
    group_data,
    legal_mask,
)
from rocalphago_tpu_torch.features.planes import true_eyes


def sensible_mask(cfg: GoConfig, state: GoState, gd=None) -> torch.Tensor:
    """bool ``[B, N]``: legal board moves that do not fill an own true
    eye (the reference's ``get_legal_moves(include_eyes=False)``). Pass
    a precomputed ``gd`` to share the group analysis."""
    if gd is None:
        gd = group_data(cfg, state.board, with_zxor=cfg.enforce_superko,
                        labels=state.labels)
    legal = legal_mask(cfg, state, gd)[:, :-1]
    return legal & ~true_eyes(cfg, state, state.turn)
