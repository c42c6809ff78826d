"""Supervised policy training: the port's SGD step
(``training/sl.py::make_train_step``) fed by its input pipeline
(``data/pipeline.py``: ``ShardedDataset`` → ``batch_iterator`` →
``device_prefetch``) from a converted corpus.

Parameters (the workload file's ``params``): ``minibatch``, ``lr``,
``prefetch`` (the prefetcher's depth), ``positions`` and
``shard_positions`` (the corpus), ``corpus_seed``, ``warmup_steps``.

The corpus is the converter's layout (``prefix-NNNNN.npz`` with uint8
NHWC ``states`` and int32 ``actions``, and ``prefix-manifest.json``),
drawn from ``corpus_seed`` and written once per checkout under
``build/portbench/``, as a user's corpus sits on disk; ``--seed`` draws
the weights, the batch order and each row's symmetry element.

Set-up drives the step through its first three steps on the window's
own feed; the check follows them with the plain reference: the first
gradient (worked out from the parameters after one step,
``(p0 − p1) / lr``) and the parameters' change after three, and that
every row fed is a corpus row and none repeats. Each step's loss gap is
printed but not compared: the float8 control's reads less than three
times the program's on some seeds, so no limit separates them.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from portbench import harness, program
from portbench.reference import compare, nets, sl as refsl

CHECKED_STEPS = 3


def corpus_prefix(run) -> str:
    """The corpus's shard prefix, written on the first run of a
    checkout (atomically: a directory renamed into place)."""
    p = run.params
    planes = run.config["policy"]["input_planes"]
    size = run.config["policy"]["board"]
    tag = (f"sl-{p['positions']}-{p['shard_positions']}-{planes}-{size}-"
           f"{p['corpus_seed']}")
    base = os.path.join(harness.ROOT, "build", "portbench", "corpus")
    final = os.path.join(base, tag)
    prefix = os.path.join(final, "corpus")
    if os.path.exists(f"{prefix}-manifest.json"):
        return prefix
    tmp = f"{final}.tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    g = torch.Generator(device=run.device)
    g.manual_seed(int(p["corpus_seed"]))
    counts = []
    for i in range(p["positions"] // p["shard_positions"]):
        n = p["shard_positions"]
        states = torch.randint(0, 2, (n, size, size, planes), generator=g,
                               device=run.device, dtype=torch.uint8)
        actions = torch.randint(0, size * size, (n,), generator=g,
                                device=run.device, dtype=torch.int32)
        np.savez(os.path.join(tmp, f"corpus-{i:05d}.npz"),
                 states=states.cpu().numpy(), actions=actions.cpu().numpy())
        counts.append(n)
    manifest = {"format": "rocalphago_tpu/npz-shards/v1",
                "board_size": size, "planes": planes, "layout": "NHWC",
                "num_shards": len(counts), "num_positions": sum(counts),
                "shard_counts": counts}
    with open(os.path.join(tmp, "corpus-manifest.json"), "w") as f:
        json.dump(manifest, f)
    try:
        os.replace(tmp, final)
    except OSError:          # another process put it there first
        pass
    return prefix


def _params(module, names):
    by_name = dict(module.named_parameters())
    return {ref: by_name[prog].detach().clone() for ref, prog in
            names.items()}


class Live:
    """The training object the window drives."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def setup(run):
    from rocalphago_tpu_torch.data.pipeline import (
        ShardedDataset,
        batch_iterator,
        device_prefetch,
    )
    from rocalphago_tpu_torch.training import sl

    p, net = run.params, run.config["policy"]
    run.lap("imports")
    prefix = corpus_prefix(run)
    run.lap("corpus")
    model, _, names = program.policy_net(net, run.generator(0), run.device)
    module = model.module
    run.lap("weights")
    if run.device.type == "cuda":
        # the SL trainer's settings on the card: deterministic
        # convolution algorithms, none picked by timing
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    cfg = sl.SLConfig(learning_rate=p["lr"], minibatch=p["minibatch"])
    opt, lr_at = sl.make_optimizer(cfg, module.parameters())
    run.lap("optimizer")
    state = sl.TrainState(module, opt, torch.Generator(device=run.device))
    step = run.seam("train_step", sl.make_train_step(
        module, opt, lr_at, net["board"], symmetries=True),
        module=module, names=names, run=run)
    dataset = ShardedDataset(prefix)
    order = np.random.default_rng(np.random.SeedSequence([run.seed, 1]))
    feed = batch_iterator(dataset, np.arange(len(dataset)), p["minibatch"],
                          order, epochs=None)
    batches = device_prefetch(feed, run.device, size=p["prefetch"])
    sym = run.generator(1)
    live = Live(step=step, state=state, batches=batches, sym=sym,
                module=module, names=names, minibatch=p["minibatch"],
                fed=[], losses=[], snaps=[_params(module, names)])
    run.lap("pipeline")
    for k in range(CHECKED_STEPS):
        planes, actions = next(batches)
        t = torch.randint(0, 8, (p["minibatch"],), generator=sym,
                          device=run.device)
        live.state, m = step(live.state, planes, actions, t)
        live.fed.append((planes, actions, t))
        live.losses.append(m["loss"])
        if k == 0:
            live.snaps.append(_params(module, names))
    live.snaps.append(_params(module, names))
    run.lap("checked_steps")
    for _ in range(p["warmup_steps"]):
        planes, actions = next(batches)
        t = torch.randint(0, 8, (p["minibatch"],), generator=sym,
                          device=run.device)
        live.state, _ = step(live.state, planes, actions, t)
    run.lap("warmup")
    return live


# ------------------------------------------------ control and faults


def _control_step(step, module, names, run):
    """The plain reference in the program's place, in float8: the same
    loss, gradient and SGD update on the module's parameters."""
    params = dict(module.named_parameters())
    net, lr = run.config["policy"], run.params["lr"]

    def control(state, planes, actions, t=None):
        leaves = {ref: params[prog] for ref, prog in names.items()}
        x = refsl.transform_boards(planes.float(), t)
        a = refsl.transform_actions(actions, t, net["board"])
        with harness.no_tf32():
            loss = refsl.policy_loss(leaves, x, a, net, quant="fp8")
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for p, g in zip(leaves.values(), grads):
                p.sub_(lr * g)
        return state, {"loss": loss.detach()}

    return control


def _unchanged(step, **_):
    """Fault: the step computes its loss and returns the state as it
    was."""
    def fault(state, planes, actions, t=None):
        with torch.no_grad():
            logits = state.module(planes.float())
            loss = torch.nn.functional.cross_entropy(
                logits, actions.long().clamp(max=logits.shape[1] - 1))
        return state, {"loss": loss}
    return fault


def _half_batch(step, **_):
    """Fault: half of the batch left out, the mean taken over the
    rest."""
    def fault(state, planes, actions, t=None):
        h = planes.shape[0] // 2
        return step(state, planes[:h], actions[:h],
                    None if t is None else t[:h])
    return fault


#: the control: the reference in float8 in the program's place
CONTROL = {"train_step": _control_step}
#: the faults this cell can have
FAULTS = {"state_unchanged": {"train_step": _unchanged},
          "half_batch": {"train_step": _half_batch}}


#: the window's sixths, each with the steps queued in it (logged only)
SLICES = 6


def window(live, run):
    steps, wait = 0, 0.0
    t0 = time.monotonic()
    deadline = t0 + run.seconds
    queued = [0] * SLICES
    while time.monotonic() < deadline:
        tw = time.monotonic()
        planes, actions = next(live.batches)
        wait += time.monotonic() - tw
        t = torch.randint(0, 8, (live.minibatch,), generator=live.sym,
                          device=run.device)
        live.state, _ = live.step(live.state, planes, actions, t)
        steps += 1
        queued[min(int((tw - t0) * SLICES / run.seconds), SLICES - 1)] += 1
    harness.sync(run.device)
    dt = time.monotonic() - t0
    run.counters.update(steps=steps, positions=steps * live.minibatch,
                        data_wait_s=wait, steps_by_sixth=queued)
    return {"seconds": dt, "attempted": steps,
            "e2e": {"train_positions_per_s": steps * live.minibatch / dt}}


def traced(live, run):
    """Steps after the window until the traced ones have run."""
    while run.tracer.tracing:
        with run.span("portbench.data_next"):
            planes, actions = next(live.batches)
        with run.span("portbench.train_step"):
            t = torch.randint(0, 8, (live.minibatch,), generator=live.sym,
                              device=run.device)
            live.state, _ = live.step(live.state, planes, actions, t)
        run.tracer.unit()


def release(live):
    live.batches.close()
    return {"fed": live.fed, "losses": [float(x) for x in live.losses],
            "snaps": live.snaps}


def _feed_faults(fed, prefix: str, device) -> tuple[int, int]:
    """``(rows that are no corpus row, rows fed twice)`` over the
    checked steps, from the corpus files as they lie on disk."""
    manifest = json.load(open(f"{prefix}-manifest.json"))
    rows = torch.cat([planes.reshape(planes.shape[0], -1)
                      for planes, _, _ in fed])
    acts = torch.cat([a for _, a, _ in fed]).long()
    # integer weights under 2**20 keep every sum exact in float64, so a
    # row's key does not depend on the order of the additions
    probe = torch.randint(0, 2**20, (rows.shape[1],),
                          generator=torch.Generator().manual_seed(7))
    probe = probe.to(device, torch.float64)
    want = rows.double() @ probe
    found = torch.full((rows.shape[0],), -1, dtype=torch.long,
                       device=device)
    base = 0
    for i, _ in enumerate(manifest["shard_counts"]):
        z = np.load(f"{prefix}-{i:05d}.npz")
        states = torch.from_numpy(z["states"]).to(device)
        actions = torch.from_numpy(z["actions"]).to(device).long()
        flat = states.reshape(states.shape[0], -1)
        keys = flat.double() @ probe
        hit = (want[:, None] == keys[None, :])
        j = hit.float().argmax(dim=1)
        ok = hit.any(dim=1)
        ok &= (flat[j] == rows).all(dim=1) & (actions[j] == acts)
        found = torch.where(ok & (found < 0), base + j, found)
        base += states.shape[0]
    missing = int((found < 0).sum())
    repeated = int(found[found >= 0].numel()
                   - torch.unique(found[found >= 0]).numel())
    return missing, repeated


def check(ev, run):
    p, net = run.params, run.config["policy"]
    limits = run.workload["limits"]
    lr = p["lr"]
    with harness.no_tf32():
        w0 = nets.make_weights(nets.policy_leaves(net), run.generator(0))
        losses, grad, w3 = refsl.sgd_steps(w0, ev["fed"], lr, net)
    p0, p1, p3 = ev["snaps"]
    g_prog = {k: (p0[k] - p1[k]) / lr for k in p0}
    keep = compare.moving_leaves(grad)
    print("loss_gap (not compared) steps " + " ".join(
        f"{(a - b) / abs(b):+.3e}" for a, b in zip(ev["losses"], losses)),
        file=sys.stderr)
    grad_gap, grad_leaf = compare.worst_norm_gap(g_prog, grad, keep)
    grad_median = compare.median_norm_gap(g_prog, grad, keep)
    change_gap, change_leaf = compare.worst_norm_gap(
        {k: p3[k] - p0[k] for k in p0}, {k: w3[k] - w0[k] for k in w0},
        keep)
    missing, repeated = _feed_faults(ev["fed"], corpus_prefix(run),
                                     run.device)
    return [harness.Check("grad_norm_gap", grad_gap, limits["grad_norm_gap"],
                          f"leaf {grad_leaf}"),
            harness.Check("grad_median_gap", grad_median,
                          limits["grad_median_gap"]),
            harness.Check("change_norm_gap", change_gap,
                          limits["change_norm_gap"], f"leaf {change_leaf}"),
            harness.Check("rows_not_in_corpus", missing, 0),
            harness.Check("rows_repeated", repeated, 0)]
