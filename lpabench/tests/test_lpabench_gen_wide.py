"""The wide web generator (``gen/powerlaw_web_wide.py``) on the CPU: at cap
40 its indices and weights are ``powerlaw_web``'s and its int64 offsets
hold the same values, whether its CSR is built in one block or in many;
its graph keeps the CSR properties of ``_check_csr`` but for the offsets'
dtype; and the it2004 configuration's expected slot count, worked out from
the size multisets alone (no graph is made), lands past 2**31 - 1 and
within 0.1% of the published 2.19 B."""
import json

import pytest
import torch

from conftest import ROOT, TINY
from lpabench.gen import make_graph
from lpabench.gen import powerlaw_web_wide as wide
from test_lpabench_gen import BIG_SEED, _check_csr


def _config(name):
    return json.loads((ROOT / "lpabench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("block_slots", [wide.BLOCK_SLOTS, 1000])
@pytest.mark.parametrize("seed", [7, BIG_SEED])
def test_cap_40_makes_powerlaw_web(monkeypatch, seed, block_slots):
    monkeypatch.setattr(wide, "BLOCK_SLOTS", block_slots)
    g = dict(_config("uk2002")["graph"], **TINY["uk2002"])
    o, i, w = make_graph("powerlaw_web", g, seed, "cpu")
    o64, i64, w64 = make_graph("powerlaw_web_wide",
                               dict(g, intra_deg_cap=40), seed, "cpu")
    assert o64.dtype == torch.int64
    assert torch.equal(o64, o.long())
    assert torch.equal(i64, i) and torch.equal(w64, w)


def test_it2004_graph_small_is_a_csr():
    g = dict(_config("it2004")["graph"], n_nodes=3000)
    o, i, w = make_graph("powerlaw_web_wide", g, BIG_SEED, "cpu")
    assert o.dtype == torch.int64
    deg = _check_csr(o.to(torch.int32), i, w, g["n_nodes"])
    assert int(deg.max()) <= g["hub_deg_max"] + g["n_nodes"]
    # a larger cap draws more edges inside the communities
    narrow = make_graph("powerlaw_web_wide", dict(g, intra_deg_cap=40),
                        BIG_SEED, "cpu")
    assert i.numel() > narrow[1].numel()


def test_expected_slots_tracks_the_drawn_graph():
    g = dict(_config("it2004")["graph"], n_nodes=100_000)
    made = make_graph("powerlaw_web_wide", g, BIG_SEED, "cpu")[1].numel()
    assert abs(made / wide.expected_slots(g) - 1) < 1e-3


def test_it2004_full_size_lands_past_int32_at_the_published_count():
    conf = _config("it2004")
    slots = wide.expected_slots(conf["graph"])
    assert slots > 2**31 - 1
    published = conf["published"]["n_slots"]
    assert abs(slots / published - 1) < 1e-3
