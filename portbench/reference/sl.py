"""Plain supervised policy steps: the dihedral transform, the
cross-entropy over board moves and plain SGD, in float32.

Group element ``t`` (0..7) acts on a board as a flip of its second axis
when ``t >= 4``, then ``t % 4`` counter-clockwise quarter turns, which
is the element the benchmark hands the program for each row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import nets


def transform_boards(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Element ``t[i]`` applied to row ``i`` of ``[B, s, s, ...]``."""
    out = torch.empty_like(x)
    for e in range(8):
        rows = (t == e).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        y = x[rows]
        if e >= 4:
            y = y.flip(2)
        out[rows] = torch.rot90(y, e % 4, dims=(1, 2))
    return out


def transform_actions(actions: torch.Tensor, t: torch.Tensor,
                      size: int) -> torch.Tensor:
    """Board actions moved by the elements; pass (``>= size²``) stays."""
    n = size * size
    onehot = F.one_hot(actions.long().clamp(max=n - 1), n).reshape(
        -1, size, size)
    moved = transform_boards(onehot, t).reshape(-1, n).argmax(dim=1)
    return torch.where(actions.long() >= n, actions.long(), moved)


def policy_loss(weights: dict, planes: torch.Tensor, actions: torch.Tensor,
                net: dict, quant: str | None = None) -> torch.Tensor:
    """Mean cross-entropy over the rows whose action is a board point."""
    logits = nets.policy_logits(weights, planes, net, quant)
    n = logits.shape[1]
    valid = (actions < n).float()
    xent = F.cross_entropy(logits, actions.long().clamp(max=n - 1),
                           reduction="none")
    return (xent * valid).sum() / valid.sum().clamp(min=1.0)


def sgd_steps(weights: dict, batches, lr: float, net: dict,
              quant: str | None = None):
    """Plain SGD over ``batches`` of ``(planes, actions, t)`` from
    ``weights``: ``(losses, first gradient, weights after)``."""
    w = {k: v.detach().clone() for k, v in weights.items()}
    losses, first = [], None
    size = net["board"]
    for planes, actions, t in batches:
        leaves = {k: v.requires_grad_(True) for k, v in w.items()}
        x = transform_boards(planes.float(), t)
        a = transform_actions(actions, t, size)
        loss = policy_loss(leaves, x, a, net, quant)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        g = dict(zip(leaves, grads))
        if first is None:
            first = {k: v.detach() for k, v in g.items()}
        w = {k: (leaves[k] - lr * g[k]).detach() for k in leaves}
        losses.append(float(loss.detach()))
    return losses, first, w
