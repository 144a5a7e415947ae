"""Rank function of the data-parallel train-step test
(``tests/test_torch_dp_train.py``).

It runs in processes that ``repro_torch.core.distributed.spawn_ranks``
starts, so it lives in an importable module, and it imports numpy and
torch only (never jax). Each rank carries the JAX initial parameters
into DCN-v2 SMOKE, takes its share of every global batch, runs
``make_dp_train_step`` and raises ``AssertionError`` when its losses or
parameters leave the JAX run's tolerance, or when its parameters differ
from rank 0's in any bit, which fails the spawning test.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.models.convert import load_jax_params
from repro_torch.models.recsys.dcn_v2 import dcn_loss, init_dcn
from repro_torch.train.steps import make_dp_train_step
from repro_torch.tree import tree_leaves


def _bits(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in tree_leaves(model)]
                     ).view(torch.int32)


def dp_matches_reference(comm, params0, batches, expected, schedule, tol):
    """``expected[tag]``: (losses [steps], final parameter leaves in the
    reference's order) of the JAX run, ``tag`` "int8" or "plain";
    ``tol``: the losses' rtol ``loss``; the parameters within ``rtol`` and
    ``atol`` but for a share ``outliers`` of them, which stay within
    ``outlier_atol``."""
    cfg = get_arch("dcn-v2").smoke
    n, r = comm.world_size, comm.rank

    def loss(model, b):
        return dcn_loss(model, b["dense"], b["sparse"], b["labels"], cfg)

    for tag, compress in (("int8", True), ("plain", False)):
        model = init_dcn(torch.Generator().manual_seed(0), cfg, device="cpu")
        load_jax_params(model, params0)
        init, step = make_dp_train_step(loss, comm, compress=compress,
                                        **schedule)
        opt, err = init(model)
        losses = []
        for batch in batches:
            share = batch["labels"].shape[0] // n
            mine = {k: torch.from_numpy(v[r * share:(r + 1) * share].copy())
                    for k, v in batch.items()}
            model, opt, err, m = step(model, opt, err, mine)
            losses.append(float(m["loss"]))
        want_losses, want_leaves = expected[tag]
        np.testing.assert_allclose(losses, want_losses, rtol=tol["loss"],
                                   err_msg=f"{tag}, rank {r}")
        got = [p.detach().numpy() for p in tree_leaves(model)]
        assert len(got) == len(want_leaves)
        want = np.concatenate([a.reshape(-1) for a in want_leaves])
        got = np.concatenate([b.reshape(-1) for b in got])
        off = ~np.isclose(got, want, rtol=tol["rtol"], atol=tol["atol"])
        assert off.mean() <= tol["outliers"], (tag, r, int(off.sum()))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol["outlier_atol"],
                                   err_msg=f"{tag}, rank {r}")
        bits = _bits(model)
        every = comm.all_gather(bits).reshape(n, -1)
        assert bool((every == every[0]).all()), \
            f"{tag}: the ranks' parameters differ"
