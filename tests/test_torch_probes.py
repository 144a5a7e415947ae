"""The LM probes (``repro_torch.launch.probes``) and the op counter behind
them (``repro_torch.launch.cost.CostCounter``) against the reference's
``repro.launch.probes``, which reads XLA's ``cost_analysis`` of compiled
probes on the CPU.

``_local_cfg``, ``lm_bytes_analytic`` and ``lm_model_flops`` are copies
and must give the reference's values exactly. ``lm_cell_cost`` counts the
port's ops on meta tensors in XLA's conventions; with the converts XLA's
CPU backend adds around bf16 ops (``flops_xla_cpu``) its FLOPs must lie
within 3% of the reference's on every train and prefill cell of the five
LM configs on the 16 x 16 production mesh and within 10% on the decode
cells (a decode step's products are matrix-vector, so its count leans on
the conventions for elementwise work and converts); its bytes are the
analytic model and equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.launch import probes as ref_probes
from repro_torch.configs.registry import get_arch
from repro_torch.launch import probes
from repro_torch.launch.cost import CostCounter
from repro_torch.models import transformer as tr
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

LM_ARCHS = ("qwen3-1.7b", "glm4-9b", "deepseek-v2-lite-16b", "granite-34b",
            "qwen3-moe-235b-a22b")
KINDS = ("train", "prefill", "decode")
#: FLOP tolerance by cell kind: a decode's count is mostly elementwise
FLOPS_TOL = {"train": 0.03, "prefill": 0.03, "decode": 0.10}


def _fields(cfg) -> dict:
    """A config's fields (nested dataclasses as dicts), its dtype by
    name."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(np.dtype(cfg.dtype)) if not isinstance(
        cfg.dtype, torch.dtype) else str(cfg.dtype).replace("torch.", "")
    return d


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_local_cfg_bytes_and_model_flops_equal_the_reference(arch):
    cfg, ref_cfg = get_arch(arch).config, ref_get_arch(arch).config
    assert _fields(cfg) == _fields(ref_cfg)
    for mm, md in ((16, 16), (1, 256), (2, 2)):
        assert _fields(probes._local_cfg(cfg, mm, md)) == _fields(
            ref_probes._local_cfg(ref_cfg, mm, md))
    for kind in KINDS:
        for batch, seq, mm, md in ((256, 4096, 1, 256), (32, 32768, 16, 16),
                                   (1, 524288, 16, 16)):
            assert probes.lm_bytes_analytic(cfg, kind, batch, seq, mm, md) \
                == ref_probes.lm_bytes_analytic(ref_cfg, kind, batch, seq,
                                                mm, md)
        assert probes.lm_model_flops(cfg, kind, 128, 4096) == \
            ref_probes.lm_model_flops(ref_cfg, kind, 128, 4096)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cell_cost_matches_the_reference_probe(arch):
    """Each of the arch's four cells on the 16 x 16 mesh, with the probe
    extents of the reference's plans: train runs context parallel (a
    probe at model 1, data 256), the others tensor parallel (16, 16)."""
    spec, ref_spec = get_arch(arch), ref_get_arch(arch)
    for cell in spec.cells:
        mm, md = (1, 256) if cell.kind == "train" else (16, 16)
        args = (cell.kind, cell.params["batch"], cell.params["seq"], mm, md)
        got = probes.lm_cell_cost(spec.config, *args)
        ref = ref_probes.lm_cell_cost(ref_spec.config, *args)
        gap = got["flops_xla_cpu"] / ref["flops"] - 1
        cls = got["by_class"]
        cpu = cls["xla_cpu_convert"]
        assert sum(cls.values()) - cpu == pytest.approx(got["flops"])
        assert got["flops"] + cpu == pytest.approx(got["flops_xla_cpu"])
        rest = got["flops"] - sum(cls[k] for k in ("product", "convert",
                                                    "elementwise",
                                                    "reduction"))
        print(f"{arch} {cell.name}: port flops {got['flops']:.5g}; with "
              f"XLA's CPU converts {got['flops_xla_cpu']:.5g} vs "
              f"{ref['flops']:.5g} ({gap:+.3%}; the CPU converts "
              f"{cpu / got['flops_xla_cpu']:.1%}); products "
              f"{cls['product']:.4g}, converts {cls['convert']:.4g}, "
              f"elementwise {cls['elementwise']:.4g}, reductions "
              f"{cls['reduction']:.4g}, rest {rest:.4g}")
        assert abs(gap) <= FLOPS_TOL[cell.kind], (cell.name, gap)
        assert got["bytes"] == ref["bytes"]


def test_counter_counts_products_as_2mnk():
    m, n, k = 5, 7, 11
    a = torch.randn(m, k)
    b = torch.randn(k, n)
    x = torch.randn(3, m, k)
    for fn, want in ((lambda: a @ b, 2 * m * n * k),
                     (lambda: torch.einsum("mk,kn->mn", a, b), 2 * m * n * k),
                     (lambda: x @ b, 3 * 2 * m * n * k),
                     (lambda: torch.einsum("bmk,kn->bnm", x, b),
                      3 * 2 * m * n * k),
                     (lambda: torch.einsum("bmk,bjk->bmj", x, x),
                      3 * 2 * m * m * k)):
        with CostCounter() as cc:
            fn()
        assert cc.by_class["product"]["flops"] == want
        assert cc.flops == want  # float32: no converts


def test_counter_conventions():
    """Elementwise 1 a result, reductions 1 an input less 1 a result,
    transcendentals apart; XLA's CPU converts of bf16 operands and
    results (both ways) kept out of ``flops``."""
    x = torch.randn(4, 8)
    with CostCounter() as cc:
        torch.where(x > 0, x, 0.0)      # compare + select: 2 x 32
        x.sum(dim=-1)                   # 32 - 4
        torch.exp(x)                    # 32 transcendentals
        x.to(torch.bfloat16)            # a convert: 32
    assert cc.flops == 64 + 28 + 32 and cc.transcendentals == 32
    h = torch.randn(4, 8).to(torch.bfloat16)
    with CostCounter() as cc:
        h * h                           # op 32; XLA's CPU: in 32, out 32
    assert cc.flops == 32 and cc.by_class["convert"]["flops"] == 0
    assert cc.by_class["xla_cpu_convert"]["flops"] == 64
    assert cc.xla_cpu_flops == 96


def test_counter_gives_the_same_totals_on_meta_and_cpu():
    """One SMOKE layer of each kind of model counts alike on meta and on
    CPU tensors (the counter reads shapes and dtypes only)."""
    for arch in ("qwen3-1.7b", "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"):
        cfg = dataclasses.replace(get_arch(arch).smoke, n_layers=1)
        totals = {}
        for dev in ("meta", "cpu"):
            if dev == "meta":
                layers = tr.param_structs(cfg)["layers"]
            else:
                layers = tr.init_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu").layers
            lp = tr._unstack(layers, 1)[0]
            x = torch.randn(2, 16, cfg.d_model).to(cfg.dtype).to(dev)
            pos = torch.arange(16, device=dev)[None].expand(2, 16)
            with torch.no_grad(), CostCounter() as cc:
                tr._layer(lp, x, cfg, pos)
            totals[dev] = cc.totals()
        assert totals["meta"] == totals["cpu"], arch
        assert totals["cpu"]["flops"] > 0


def test_probe_counts_the_masked_square():
    """The probe runs attention unchunked: its layer FLOPs hold both
    products of the whole S x S score square (masked half included)."""
    cfg = get_arch("qwen3-1.7b").config
    b, s = 1, 1024
    probe = probes.lm_fwd_probe(cfg, b, s, 16, 1)
    h, dh = cfg.n_heads // 16, cfg.d_head
    products = probe["layer_by_class"]["product"]["flops"]
    square = 2 * 2 * b * h * s * s * dh
    d, kv = cfg.d_model, max(1, cfg.n_kv_heads // 16)
    linear = 2 * b * s * (d * h * dh * 2 + 2 * d * kv * dh
                          + 3 * d * cfg.d_ff // 16)
    assert products == square + linear


def test_probe_minus_lm_cost_is_the_masked_half_and_the_rest():
    """On one card the probe's forward FLOPs exceed ``launch.serve.
    lm_cost``'s by exactly the masked half of the score square's two
    products, the elementwise work (the port's converts and reductions
    included) and the head at every position but the last: qwen3-1.7b's
    ``prefill_32k`` call of phase 9 (2 x 32,768); with XLA's CPU
    converts, against the reference's probe of the same call too."""
    from repro_torch.launch.serve import lm_cost
    cfg = get_arch("qwen3-1.7b").config
    b, s = 2, 32768
    p = probes.lm_fwd_probe(cfg, b, s, 1, 1)
    L, h, dh = cfg.n_layers, cfg.n_heads, cfg.d_head
    full = L * 2 * 2 * b * h * s * s * dh
    causal = L * b * (2 * h * 2 * dh) * s * (s + 1) // 2
    port = ("product", "xla_cpu_convert")
    other = (L * sum(v["flops"] for k, v in p["layer_by_class"].items()
                     if k not in port)
             + sum(v["flops"] for k, v in p["head_by_class"].items()
                   if k not in port))
    head = 2 * b * (s - 1) * cfg.d_model * cfg.vocab
    cost = lm_cost(cfg, "prefill", b, s)["flops"]
    ref = ref_probes.lm_cell_cost(ref_get_arch("qwen3-1.7b").config,
                                  "prefill", b, s, 1, 1)["flops"]
    print(f"probe {p['fwd_flops']:.5g} (with XLA's CPU converts "
          f"{p['fwd_flops_xla_cpu']:.5g}, reference {ref:.5g}) - lm_cost "
          f"{cost:.5g} = masked half {full - causal:.5g} + elementwise "
          f"{other:.5g} + head {head:.5g}")
    assert p["fwd_flops"] - cost == (full - causal) + other + head
    assert abs(p["fwd_flops_xla_cpu"] / ref - 1) <= FLOPS_TOL["prefill"]
