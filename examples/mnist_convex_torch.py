"""Paper Section 5.2 on the PyTorch/CUDA port: convex softmax regression
with R=15 workers, batch 8, Top_k with k=40 coordinates,
lr = c/(lambda (a+t)), synchronous (Algorithm 1) and asynchronous
(Algorithm 2) operation.  The twin of ``examples/mnist_convex.py``.

Run:  PYTHONPATH=src python examples/mnist_convex_torch.py [--steps 400] \\
          [--device cpu] [--dispatch kernel]
"""

import argparse

from repro_torch.core.operators import (
    Identity, QSGDQuantizer, QuantizedSparsifier, Sign, SignSparsifier, TopK,
)
from repro_torch.data import mnist_like, worker_batches
from repro_torch.models import softmax
from repro_torch.optim import inverse_time, sgd
from repro_torch.train import RunConfig, train
from repro_torch.tree import value_and_grad

R, B = 15, 8
K = 40 / 7850.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--target", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--dispatch", choices=("auto", "kernel", "reference"),
                    default="auto",
                    help="kernel routing (these leaves are below the "
                         "kernels' min_size under auto)")
    args = ap.parse_args()
    T = args.steps

    x, y = mnist_like(6000, seed=0)
    cfg = softmax.SoftmaxConfig(l2=1.0 / len(x))
    grad_fn = value_and_grad(lambda p, batch: softmax.loss_fn(p, batch,
                                                             cfg)[0])
    lr = inverse_time(xi=60.0, a=100.0)

    methods = [
        ("vanilla SGD", Identity(), 1, False),
        ("TopK-SGD [SCJ18]", TopK(k=K), 1, False),
        ("EF-SIGNSGD [KRSJ19]", Sign(), 1, False),
        ("EF-QSGD [WHHZ18]", QSGDQuantizer(s=15), 1, False),
        ("QTopK (Lemma 1)", QuantizedSparsifier(k=K, s=15), 1, False),
        ("SignTopK (Lemma 3)", SignSparsifier(k=K, m=1), 1, False),
        ("local SGD H=8 [Sti19]", Identity(), 8, False),
        ("Qsparse-local QTopK H=8", QuantizedSparsifier(k=K, s=15), 8, False),
        ("Qsparse-local SignTopK H=8", SignSparsifier(k=K, m=1), 8, False),
        ("async SignTopK H=8 (Alg 2)", SignSparsifier(k=K, m=1), 8, True),
    ]
    print(f"{'method':30s} {'loss':>7s} {'Mbits':>10s} "
          f"{'bits->target':>14s} {'rounds':>7s}")
    base_bits = None
    for name, op, H, asy in methods:
        run = RunConfig(total_steps=T, R=R, H=H, asynchronous=asy,
                        log_every=50, target_loss=args.target,
                        dispatch=args.dispatch)
        state, hist = train(grad_fn,
                            softmax.init_params(cfg, device=args.device),
                            sgd(), op, lr,
                            worker_batches(x, y, R, B, T, seed=1), run,
                            device=args.device)
        btt = hist.bits_to_target
        if name == "vanilla SGD":
            base_bits = btt
        rel = (f"{base_bits / btt:7.0f}x less" if btt and base_bits else "")
        print(f"{name:30s} {hist.loss[-1]:7.3f} "
              f"{hist.bits[-1] / 1e6:10.2f} "
              f"{(f'{btt:.3g}' if btt else 'n/a'):>14s} "
              f"{hist.rounds[-1]:7d}  {rel}")


if __name__ == "__main__":
    main()
