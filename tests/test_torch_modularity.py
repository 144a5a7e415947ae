"""The port's modularity against the JAX package's on the CPU. Its
per-segment sums (``_segment_sum``: a stable sort into segment order,
then each segment added in index order) equal ``jax.ops.segment_sum``'s
bit for bit; modularity itself agrees within 1e-5, the tolerance of the
end-to-end parity tests (its final sums over the segments are
``torch.sum``'s, in another order than XLA's), and two calls on the same
labels give the same bits. ``tests/test_torch_cuda_kernels.py`` holds the
repeated calls to equal bits on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs.generators as jgen
import repro_torch.graphs.generators as tgen
from repro.core.modularity import modularity as jmodularity
from repro_torch.core.lpa import LPAConfig, lpa
from repro_torch.core.modularity import _segment_sum, modularity
from _torch_parity import CPU


def test_segment_sums_equal_the_reference_bit_for_bit():
    """Non-dyadic values over segments in random order, one of them a
    quarter of all values: every sum is the reference's left fold."""
    rng = np.random.default_rng(0)
    m, n = 200_000, 3000
    seg = rng.integers(0, n - 1, m).astype(np.int32)  # segment n-1 empty
    seg[: m // 4] = 7
    rng.shuffle(seg)
    values = (rng.random(m) * 3 + 0.1).astype(np.float32)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(values),
                                         jnp.asarray(seg), num_segments=n))
    got = _segment_sum(torch.from_numpy(values), torch.from_numpy(seg), n)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.view(np.int32))


@pytest.mark.parametrize("labelling", ["bm", "planted", "random"])
def test_modularity_matches_reference(labelling):
    gj, truth = jgen.powerlaw_communities(4096, p_in=0.5, mix=0.02, seed=1)
    gt, _ = tgen.powerlaw_communities(4096, p_in=0.5, mix=0.02, seed=1,
                                      device=CPU)
    if labelling == "bm":
        labels = lpa(gt, LPAConfig(method="bm"), device=CPU).labels
    elif labelling == "planted":
        labels = torch.as_tensor(np.asarray(truth), dtype=torch.int32)
    else:
        labels = torch.from_numpy(np.random.default_rng(3).integers(
            0, 40, gt.n_nodes).astype(np.int32))
    q_ref = float(jmodularity(gj, jnp.asarray(labels.numpy())))
    q = modularity(gt, labels)
    assert abs(float(q) - q_ref) <= 1e-5, (float(q), q_ref)
    again = modularity(gt, labels.clone())
    assert q.reshape(1).view(torch.int32).item() == \
        again.reshape(1).view(torch.int32).item()
