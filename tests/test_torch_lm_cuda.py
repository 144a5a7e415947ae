"""The LM family on the card against the CPU (``repro_torch``).

Marked ``gpu``: without a CUDA device every test here skips (the decision
is taken inside the ``cuda`` fixture, never at import). On a machine with
one: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_lm_cuda.py``. Imports torch and numpy only (the card's
machine has no JAX).

Each LM arch's SMOKE config in float32 with TF32 off, one state dict on
the card and on the CPU: the forward's hidden states, the loss and a
12-token decode's logits within rtol = atol = 1e-4, and three train
steps' losses and parameters within 1e-4 (sums on the card add in
another order); the decode's last logits equal the card's own forward's
(2e-4 dense, 5e-4 MLA, the MoE capacity raised so nothing drops).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data.synthetic import token_batch
from repro_torch.launch.cells import build_lm_train
from repro_torch.configs.registry import ShapeCell
from repro_torch.models import transformer as tr
from repro_torch.optim.adamw import adamw_init
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.gpu

LM_ARCHS = ["deepseek-v2-lite-16b", "glm4-9b", "granite-34b", "qwen3-1.7b",
            "qwen3-moe-235b-a22b"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests run the LM family on "
                    "the card")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old[0]
    torch.set_float32_matmul_precision(old[1])


def _cfg(arch):
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
    if cfg.moe is not None:
        cf = max(8.0, cfg.moe.n_experts / cfg.moe.top_k)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def _pair(cfg, cuda):
    cpu = tr.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = tr.init_params(torch.Generator().manual_seed(0), cfg,
                          device=cuda)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _close(a, b, what):
    torch.testing.assert_close(a.detach().cpu(), b.detach().cpu(), **TOL,
                               msg=what)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_loss_and_decode_equal_the_cpu(arch, cuda):
    cfg = _cfg(arch)
    cpu, card = _pair(cfg, cuda)
    batch = token_batch(0, 0, 3, 16, cfg.vocab, device="cpu")
    outs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            h = tr.forward(model, b["tokens"], cfg)
            loss = tr.loss_fn(model, b["tokens"], b["targets"], cfg)
        cache = tr.init_cache(cfg, 3, 12, device=dev)
        for i in range(12):
            logits, cache = tr.decode_step(
                model, cache, b["tokens"][:, i],
                torch.full((3,), i, dtype=torch.int32, device=dev), cfg)
        outs[name] = (h, loss, logits, cache)
        with torch.no_grad():
            h12 = tr.forward(model, b["tokens"][:, :12], cfg)
        tol = 5e-4 if cfg.mla is not None else 2e-4
        torch.testing.assert_close(logits, h12[:, -1] @ model.lm_head,
                                   rtol=tol, atol=tol)
    for i, what in enumerate(("hidden", "loss", "decode logits")):
        _close(outs["cpu"][i], outs["card"][i], what)
    for key in outs["cpu"][3]:
        _close(outs["cpu"][3][key], outs["card"][3][key], key)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_steps_equal_the_cpu(arch, cuda):
    spec = dataclasses.replace(get_arch(arch), config=_cfg(arch))
    plan = build_lm_train(spec, ShapeCell("t", "train",
                                          {"seq": 16, "batch": 2}))
    cpu, card = _pair(spec.config, cuda)
    states = {"cpu": (cpu, adamw_init(cpu)), "card": (card, adamw_init(card))}
    for step in range(3):
        losses = {}
        for name, dev in (("cpu", "cpu"), ("card", cuda)):
            model, opt = states[name]
            b = token_batch(0, step, 2, 16, spec.config.vocab, device=dev)
            model, opt, m = plan.fn(model, opt, b)
            states[name] = (model, opt)
            losses[name] = m["loss"]
        _close(losses["cpu"], losses["card"], f"loss, step {step}")
    for a, b in zip(tree_leaves(states["cpu"][0]),
                    tree_leaves(states["card"][0])):
        _close(a, b, "parameters after 3 steps")
