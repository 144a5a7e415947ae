"""The port's fault-tolerant training loop (``repro_torch.train.loop``):
the claims of the reference's ``tests/test_train_loop.py`` on the CPU
(crash-and-resume reproduces the uninterrupted run bit for bit), the
launcher ``repro_torch.launch.train`` doing the same for DCN-v2 SMOKE,
and the port's ``dcn_batch`` a pure function of (seed, step)."""
import numpy as np
import pytest
import torch

from repro_torch.data import synthetic
from repro_torch.data.synthetic import dcn_batch
from repro_torch.launch import train as launch_train
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.train.loop import LoopConfig, SimulatedFailure, run_training
from repro_torch.train.steps import value_and_grad
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

QUIET = dict(log=lambda *_: None)


def _setup():
    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2)

    def step_fn(params, opt_state, batch):
        loss, g = value_and_grad(loss_fn, params, batch)
        params, opt_state, _ = adamw_update(g, opt_state, params, 0.05)
        return params, opt_state, {"loss": loss, "lr": torch.tensor(0.05)}

    def batch_fn(step):
        gen = torch.Generator().manual_seed(step)
        x = torch.randn(16, 4, generator=gen)
        w_true = torch.tensor([1.0, -2.0, 0.5, 3.0])
        return {"x": x, "y": x @ w_true}

    return step_fn, batch_fn, {"w": torch.zeros(4)}


def test_training_reduces_loss(tmp_path):
    step_fn, batch_fn, params = _setup()
    cfg = LoopConfig(total_steps=40, ckpt_every=100,
                     ckpt_dir=str(tmp_path / "a"), log_every=1000)
    _, _, hist = run_training(step_fn, batch_fn, params, adamw_init(params),
                              cfg, **QUIET)
    assert hist[-1] < 0.1 * hist[0]


def test_crash_resume_bitwise_identical(tmp_path):
    step_fn, batch_fn, params = _setup()
    # uninterrupted reference
    cfg_ref = LoopConfig(total_steps=30, ckpt_every=10,
                         ckpt_dir=str(tmp_path / "ref"), log_every=1000)
    _, _, hist_ref = run_training(step_fn, batch_fn, params,
                                  adamw_init(params), cfg_ref, **QUIET)
    # crashed run: dies at step 17 (after the step-10 checkpoint)
    cfg_crash = LoopConfig(total_steps=30, ckpt_every=10,
                           ckpt_dir=str(tmp_path / "crash"), log_every=1000,
                           fail_at_step=17)
    with pytest.raises(SimulatedFailure):
        run_training(step_fn, batch_fn, params, adamw_init(params),
                     cfg_crash, **QUIET)
    # restart resumes from step 10 and finishes
    cfg_resume = LoopConfig(total_steps=30, ckpt_every=10,
                            ckpt_dir=str(tmp_path / "crash"), log_every=1000)
    _, _, hist_resume = run_training(step_fn, batch_fn, params,
                                     adamw_init(params), cfg_resume, **QUIET)
    # the resumed tail must equal the reference tail bit for bit
    np.testing.assert_array_equal(np.asarray(hist_resume),
                                  np.asarray(hist_ref[10:]))


def test_deterministic_batches():
    _, batch_fn, _ = _setup()
    b1, b2 = batch_fn(7), batch_fn(7)
    assert torch.equal(b1["x"], b2["x"])
    assert not torch.equal(b1["x"], batch_fn(8)["x"])


def test_synthetic_pipelines_deterministic():
    c = dcn_batch(0, 3, 8, 4, 2, (10, 20), device="cpu")
    d = dcn_batch(0, 3, 8, 4, 2, (10, 20), device="cpu")
    for key in ("dense", "sparse", "labels"):
        assert torch.equal(c[key], d[key])
    assert c["labels"].shape == (8,)
    assert c["sparse"].dtype == torch.int32
    assert c["dense"].dtype == c["labels"].dtype == torch.float32
    assert int(c["sparse"][:, 1].max()) < 20
    other = dcn_batch(0, 4, 8, 4, 2, (10, 20), device="cpu")
    assert not torch.equal(c["dense"], other["dense"])


def test_dcn_batch_rule_depends_on_the_seed_only():
    """Every step's labels are the planted rule of the base seed: the sign
    of dense @ w + 0.3 (id_0 mod 5 - 2), one w drawn from the seed alone;
    another seed plants another rule."""
    w = torch.randn(13, generator=synthetic._generator(5))
    for s in range(3):
        b = dcn_batch(5, s, 256, 13, 4, (64, 32, 128, 16), device="cpu")
        rule = b["dense"] @ w + 0.3 * (b["sparse"][:, 0].long() % 5 - 2)
        assert torch.equal(b["labels"], (rule > 0).to(torch.float32))
        assert 0.2 < float(b["labels"].mean()) < 0.8
    w6 = torch.randn(13, generator=synthetic._generator(6))
    assert not torch.equal(w, w6)


def test_launcher_resumes_bitwise_identical(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch dcn-v2 --device cpu``:
    a run killed at step 6 and relaunched ends as the uninterrupted run
    (the tail of the losses equal bit for bit, the last checkpoint's
    arrays equal)."""
    common = ["--arch", "dcn-v2", "--steps", "12", "--ckpt-every", "4",
              "--device", "cpu"]
    ref = launch_train.main(common + ["--ckpt-dir", str(tmp_path / "ref")])
    crash = common + ["--ckpt-dir", str(tmp_path / "crash")]
    with pytest.raises(SimulatedFailure):
        launch_train.main(crash + ["--fail-at", "6"])
    tail = launch_train.main(crash)
    assert len(tail) == 8
    np.testing.assert_array_equal(np.asarray(tail), np.asarray(ref[4:]))
    with np.load(tmp_path / "ref" / "step_00000012" / "host_0.npz") as a, \
            np.load(tmp_path / "crash" / "step_00000012" / "host_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    assert not torch.are_deterministic_algorithms_enabled()
    assert '"start": 4' in capsys.readouterr().out


def test_launcher_families(tmp_path, capsys):
    """The LM family trains (the default arch, qwen3-1.7b SMOKE, one step
    on the CPU at ``--seq``); a GNN arch points to the cells; without a
    card the default device raises."""
    hist = launch_train.main(["--steps", "1", "--seq", "16", "--ckpt-dir",
                              str(tmp_path), "--device", "cpu"])
    assert len(hist) == 1 and np.isfinite(hist[0])
    assert '"start": 0' in capsys.readouterr().out
    with pytest.raises(SystemExit, match="launch.cells"):
        launch_train.main(["--arch", "pna", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch_train.main(["--steps", "1"])
