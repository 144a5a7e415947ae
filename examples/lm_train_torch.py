"""End-to-end LM training with checkpoint/restart fault tolerance,
on the PyTorch/CUDA port (``src/repro_torch``); the port's counterpart of
``lm_train.py``.

Trains a small qwen3-style decoder on the synthetic token pipeline,
injects a failure two thirds of the way in, restarts, and prints the
resumed loss curve, which continues exactly where it left off.

  PYTHONPATH=src python examples/lm_train_torch.py                # on the card
  PYTHONPATH=src python examples/lm_train_torch.py --device cpu [--steps 60]

--d-model 768 --layers 12 gives a ~100M-param model (same code path).
"""
import argparse
import dataclasses
import shutil
import tempfile

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data.synthetic import token_batch
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params, loss_fn
from repro_torch.train.loop import LoopConfig, SimulatedFailure, run_training
from repro_torch.train.steps import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = get_arch("qwen3-1.7b").smoke
    cfg = dataclasses.replace(
        base, n_layers=args.layers, d_model=args.d_model,
        n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(2, args.d_model // 128),
        d_head=args.d_model // max(4, args.d_model // 64) * 2,
        d_ff=args.d_model * 4, vocab=512)
    print(f"model: {cfg.n_layers}L d={cfg.d_model} "
          f"(~{cfg.n_params / 1e6:.1f}M params) on {device}")

    def loss(params, b):
        return loss_fn(params, b["tokens"], b["targets"], cfg)

    init, step = make_train_step(loss, peak_lr=3e-3, warmup=10, total=1000)
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device=device)
    opt = init(params)

    def batch_fn(s):
        return token_batch(0, s, args.batch, args.seq, cfg.vocab,
                           device=device)

    ckpt = tempfile.mkdtemp(prefix="lm_train_ckpt_")
    try:
        fail_at = args.steps * 2 // 3
        loop = LoopConfig(total_steps=args.steps, ckpt_every=10,
                          ckpt_dir=ckpt, log_every=10, fail_at_step=fail_at)
        print(f"\n-- run 1 (will fail at step {fail_at}) --")
        try:
            run_training(step, batch_fn, params, opt, loop)
        except SimulatedFailure as e:
            print(f"!! {e} — restarting from the last checkpoint")
        loop2 = LoopConfig(total_steps=args.steps, ckpt_every=10,
                           ckpt_dir=ckpt, log_every=10)
        print("\n-- run 2 (auto-resume) --")
        _, _, hist = run_training(step, batch_fn, params, opt, loop2)
        print(f"resumed loss curve: {[round(x, 4) for x in hist]}")
        print(f"\nfinal loss {hist[-1]:.4f} (from {hist[0]:.4f} at resume "
              f"point); training survived the failure with no lost steps.")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
