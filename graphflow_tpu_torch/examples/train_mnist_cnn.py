"""The CNN on MNIST (counterpart of ``examples/train_mnist_cnn.py``; the
reference's ``tests/test_CNN_MNIST_MaxPool.cpp``).  Reads the idx files of
``mnist_dir`` where both are there (the reference repo ships the label
files; the image files must be fetched separately), else trains on the
synthetic class-separable digits.

Run:  python -m graphflow_tpu_torch.examples.train_mnist_cnn [epochs [mnist_dir]]
"""

from __future__ import annotations

import os
import sys

from graphflow_tpu_torch.models import CNN
from graphflow_tpu_torch.utils import datasets


def load(mnist_dir: str):
    img = os.path.join(mnist_dir, "train-images.idx3-ubyte")
    lab = os.path.join(mnist_dir, "train-labels.idx1-ubyte")
    if os.path.exists(img) and os.path.exists(lab):
        xs = datasets.load_mnist_images(img)[:4096]
        ys = datasets.load_mnist_labels(lab)[:4096]
        print(f"loaded {len(xs)} real MNIST digits")
        return xs, ys
    print("MNIST images not found; using synthetic digits")
    return datasets.synthetic_mnist(1024)


def main(epochs: int = 10, mnist_dir: str = "data/MNIST",
         device=None) -> list:
    """Train ``epochs`` epochs of 64-image BatchLearn steps; returns the
    test accuracy after each."""
    xs, ys = load(mnist_dir)
    n_test = len(xs) // 8
    xt, yt = xs[:n_test], ys[:n_test]
    xs, ys = xs[n_test:], ys[n_test:]

    model = CNN(optimizer="adam", lam=1e-4, device=device)
    accuracy = []
    for epoch in range(epochs):
        total = 0.0
        for i in range(0, len(xs), 64):
            total += model.BatchLearn(xs[i:i + 64], ys[i:i + 64], 2e-3)
        accuracy.append(model.accuracy(xt, yt))
        print(f"epoch {epoch}: loss {total:.1f}  test accuracy "
              f"{accuracy[-1]:.3f}")
    return accuracy


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10,
         *sys.argv[2:3])
