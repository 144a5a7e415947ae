"""The leaf-by-leaf form of the AdamW update, the oracle of the port's
batched ``repro_torch.optim.adamw.adamw_update``. Torch and numpy only:
the card tests (``tests/test_torch_train_cuda.py``) use it too."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import tree_leaves


def leaf_by_leaf_update(grads, state, params, lr, cfg=AdamWConfig()):
    """The reference's update written leaf by leaf in torch: (params, m,
    v) leaf lists."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    step = state["step"] + 1
    bc1 = 1.0 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1.0 - cfg.b2 ** step.to(torch.float32)
    out = []
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"]), tree_leaves(params)):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        out.append(((p - lr * delta.to(p.dtype)).to(p.dtype), m, v))
    return [list(x) for x in zip(*out)]


def check_batched_update(device) -> None:
    """``adamw_update`` equals the leaf-by-leaf form bit for bit over 6
    steps on ``device`` (leaves of several shapes, clipped gradients)."""
    rng = np.random.default_rng(3)
    shapes = {"w": (6, 5), "b": (4,), "a_bias": (3,), "table": (37, 8)}
    params = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              .to(device) for k, s in shapes.items()}
    state = adamw_init(params)
    for i in range(6):
        grads = {k: torch.from_numpy((3 * rng.normal(size=s))
                                     .astype(np.float32)).to(device)
                 for k, s in shapes.items()}
        lr = torch.tensor(1e-2 * (i + 1), device=device)
        want = leaf_by_leaf_update(grads, state, params, lr)
        params, state, _ = adamw_update(grads, state, params, lr)
        for ref, got in zip(want, (params, state["m"], state["v"])):
            for a, b in zip(ref, tree_leaves(got)):
                assert torch.equal(a, b)
