"""Quickstart on the PyTorch/CUDA port: Qsparse-local-SGD in ~60 lines.

The twin of ``examples/quickstart.py`` on ``repro_torch``: the paper's
convex objective (softmax regression on MNIST-shaped data) with 8
workers, vanilla distributed SGD against Qsparse-local-SGD (SignTop_k +
error feedback + H=4 local steps), and the bits each needs to reach the
same loss.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

from repro_torch.core.operators import Identity, SignSparsifier
from repro_torch.data import mnist_like, worker_batches
from repro_torch.models import softmax
from repro_torch.optim import inverse_time, sgd
from repro_torch.train import RunConfig, train
from repro_torch.tree import value_and_grad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    R, b, T = 8, 8, 300
    x, y = mnist_like(4000, seed=0)
    cfg = softmax.SoftmaxConfig(l2=1.0 / len(x))
    grad_fn = value_and_grad(lambda p, batch: softmax.loss_fn(p, batch,
                                                             cfg)[0])
    lr = inverse_time(xi=60.0, a=100.0)
    print(f"{'method':24s} {'loss':>8s} {'Mbits':>10s} {'rounds':>7s}")
    results = {}
    for name, op, H in [
        ("vanilla SGD", Identity(), 1),
        ("Qsparse-local (SignTopK)", SignSparsifier(k=0.01, m=1), 4),
    ]:
        run = RunConfig(total_steps=T, R=R, H=H, log_every=50,
                        target_loss=1.0)
        state, hist = train(
            grad_fn, softmax.init_params(cfg, device=args.device), sgd(), op,
            lr, worker_batches(x, y, R, b, T, seed=1), run,
            device=args.device)
        results[name] = hist
        print(f"{name:24s} {hist.loss[-1]:8.3f} "
              f"{hist.bits[-1] / 1e6:10.2f} {hist.rounds[-1]:7d}")
    v = results["vanilla SGD"]
    q = results["Qsparse-local (SignTopK)"]
    if v.bits_to_target and q.bits_to_target:
        print(f"\nbits to reach loss 1.0:  vanilla {v.bits_to_target:.3g}  "
              f"qsparse {q.bits_to_target:.3g}  "
              f"(saving {v.bits_to_target / q.bits_to_target:.0f}x)")


if __name__ == "__main__":
    main()
