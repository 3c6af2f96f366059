from repro_torch.data.synthetic import (
    LMTokenStream,
    make_classification_data,
    make_image_data,
    mnist_like,
    worker_batches,
)

__all__ = [
    "LMTokenStream",
    "make_classification_data",
    "make_image_data",
    "mnist_like",
    "worker_batches",
]
