"""Fault-tolerant training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 50 --ckpt-dir DIR [--full] [--device cpu] [--fail-at 30]

A torch copy of ``repro.launch.train``. The arch's reduced (smoke) config
by default, ``--full`` the production one; on the card by default,
``--device cpu`` asks for the CPU. Auto-resumes from the latest
checkpoint in ``--ckpt-dir``: kill it mid-run, relaunch the same command,
and it continues from the last checkpoint with bitwise-identical
results. For that the launcher turns on
``torch.use_deterministic_algorithms(True)`` and sets
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (unless already set) before CUDA
starts. The last line it prints is JSON: the losses of the steps this
run took, and the step it started from.

The LM family (on ``token_batch`` batches of ``--batch`` x ``--seq``)
and the recsys family (DCN-v2) run; GNN training is driven from
``repro_torch.launch.cells`` (``chip_smoke.py``), as the reference points
its GNN users to examples/.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile


def build_lm(cfg, batch, seq, seed=0, device=None):
    """(model, opt_state, step, batch_fn) of a transformer LM at ``cfg``."""
    import torch
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.train.steps import make_train_step

    def loss(params, b):
        return loss_fn(params, b["tokens"], b["targets"], cfg)

    init, step = make_train_step(loss, peak_lr=3e-3, warmup=20, total=2000)
    model = init_params(torch.Generator().manual_seed(seed), cfg,
                        device=device)
    return (model, init(model), step,
            lambda s: token_batch(seed, s, batch, seq, cfg.vocab,
                                  device=device))


def build_recsys(cfg, batch, seed=0, device=None):
    """(model, opt_state, step, batch_fn) of DCN-v2 at ``cfg``."""
    import torch
    from repro_torch.data.synthetic import dcn_batch
    from repro_torch.models.recsys.dcn_v2 import dcn_loss, init_dcn
    from repro_torch.train.steps import make_train_step

    def loss(params, b):
        return dcn_loss(params, b["dense"], b["sparse"], b["labels"], cfg)

    init, step = make_train_step(loss, peak_lr=3e-3, warmup=20, total=2000)
    model = init_dcn(torch.Generator().manual_seed(seed), cfg, device=device)
    return (model, init(model), step,
            lambda s: dcn_batch(seed, s, batch, cfg.n_dense, cfg.n_sparse,
                                cfg.vocab_sizes, device=device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--full", action="store_true",
                    help="production config")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (restart demo)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.train.loop import LoopConfig, run_training

    spec = get_arch(args.arch)
    cfg = spec.config if args.full else spec.smoke
    if spec.family not in ("lm", "recsys"):
        raise SystemExit(f"--arch {args.arch}: use repro_torch.launch.cells "
                         f"for {spec.family} training drivers")
    device = resolve_device(args.device)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        if spec.family == "lm":
            params, opt, step, batch_fn = build_lm(cfg, args.batch,
                                                   args.seq, device=device)
        else:
            params, opt, step, batch_fn = build_recsys(cfg, args.batch,
                                                       device=device)
        loop = LoopConfig(total_steps=args.steps,
                          ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                          log_every=5, fail_at_step=args.fail_at)
        _, _, hist = run_training(step, batch_fn, params, opt, loop)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
    print(f"done: loss {hist[0]:.4f} -> {hist[-1]:.4f} "
          f"over {len(hist)} steps (resumed runs show only the tail)")
    print(json.dumps({"history": hist,
                      "start": args.steps - len(hist)}))
    return hist


if __name__ == "__main__":
    main()
