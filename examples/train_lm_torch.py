"""End-to-end LM training on the PyTorch/CUDA port: the twin of
``examples/train_lm.py``.  A transformer trained with Qsparse-local-SGD
(SignTop_k, H local steps) on the synthetic Markov token stream, with
eval, the bits ledger and checkpoints.

``--preset 5m`` (default) and ``--preset 100m`` are ``train_lm.py``'s
configs.  The other model families train through the LM launcher,
``python -m repro_torch.launch.train --arch <id> --smoke``.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --steps 200 \\
          [--device cpu]
"""

import argparse
import math
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.operators import SignSparsifier
from repro_torch.data import LMTokenStream
from repro_torch.models import get_model
from repro_torch.optim import momentum_sgd, warmup_piecewise
from repro_torch.train import RunConfig, train
from repro_torch.tree import tree_leaves, value_and_grad

PRESETS = {
    "5m": ModelConfig(
        name="lm5m", family="dense", n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=2, d_ff=1024, vocab=2048, max_seq_len=512,
        param_dtype="float32", act_dtype="float32", q_chunk=64),
    "100m": ModelConfig(
        name="lm100m", family="dense", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=3072, vocab=8192, max_seq_len=1024,
        param_dtype="float32", act_dtype="float32", q_chunk=128),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="5m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--H", type=int, default=4)
    ap.add_argument("--k", type=float, default=0.01)
    ap.add_argument("--ckpt", default="artifacts/lm_ckpt_torch")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = PRESETS[args.preset]
    model = get_model(cfg)
    params = model.init_params(torch.Generator(device=args.device)
                               .manual_seed(0), cfg, device=args.device)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"model {cfg.name}: {n / 1e6:.1f}M params, R={args.workers}, "
          f"H={args.H}, SignTopK k={args.k}")

    grad_fn = value_and_grad(lambda p, b: model.loss_fn(p, b, cfg)[0])
    stream = LMTokenStream(vocab=cfg.vocab, R=args.workers, order=64, seed=0)
    eval_batch = next(stream.batches(8, args.seq, 1, seed=999))
    eval_tokens = torch.from_numpy(
        eval_batch["tokens"].reshape(-1, args.seq + 1)).to(args.device)

    def eval_loss(p):
        with torch.no_grad():
            return float(model.loss_fn(p, {"tokens": eval_tokens}, cfg)[0])

    lr = warmup_piecewise(0.3, 20, [int(args.steps * 0.7)])
    op = SignSparsifier(k=args.k, m=1)
    run = RunConfig(total_steps=args.steps, R=args.workers, H=args.H,
                    log_every=20, ckpt_dir=args.ckpt,
                    ckpt_every=max(50, args.steps // 4),
                    eval_every=max(20, args.steps // 10))
    t0 = time.time()
    state, hist = train(
        grad_fn, params, momentum_sgd(0.9), op, lr,
        stream.batches(args.batch, args.seq, args.steps, seed=1), run,
        eval_fn=lambda p: {"eval_loss": eval_loss(p)}, device=args.device)
    dt = time.time() - t0
    print(f"\nsteps/s: {args.steps / dt:.2f}   total bits: "
          f"{hist.bits[-1]:.3g}  sync rounds: {hist.rounds[-1]}")
    print("train loss trace:", [round(l, 3) for l in hist.loss])
    print("eval:", hist.eval_metrics)
    uniform = math.log(cfg.vocab)
    assert hist.loss[-1] < uniform - 0.5, "did not learn structure"
    print(f"final loss {hist.loss[-1]:.3f} << uniform {uniform:.3f}  "
          f"(checkpoints in {args.ckpt})")


if __name__ == "__main__":
    main()
