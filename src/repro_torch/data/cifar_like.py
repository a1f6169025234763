"""Synthetic CIFAR-like classification data + the paper's non-IID partitioner.

Real CIFAR-10 cannot be downloaded in this container (DESIGN.md §7).  The
synthetic task: each class c has a set of random spatial "prototype" patterns
mixed through a shared random convolutional basis, plus per-sample noise and
random shifts — learnable by a small CNN, non-trivially (a linear model does
not saturate it).  Absolute accuracies are not comparable to real CIFAR-10;
the DRT-vs-classical comparisons across topologies are.

The non-IID partition follows §IV.A exactly: each agent draws its number of
classes uniformly from {5..8} and its sample count from {1500..2000}, sampled
without replacement from the pool.

A numpy copy of ``repro.data.cifar_like`` (the port imports nothing of the
JAX package): the same seeds give bit-identical arrays, in the same NHWC
image layout.  The model converts to NCHW on its way in.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CifarLikeConfig:
    num_classes: int = 10
    image_size: int = 32
    channels: int = 3
    prototypes_per_class: int = 3
    noise: float = 0.4
    max_shift: int = 2
    seed: int = 0


class CifarLike:
    def __init__(self, cfg: CifarLikeConfig = CifarLikeConfig()):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        s, ch, C, P = cfg.image_size, cfg.channels, cfg.num_classes, cfg.prototypes_per_class
        # low-frequency class prototypes: random coarse grids upsampled
        coarse = rng.normal(size=(C, P, 8, 8, ch)).astype(np.float32)
        up = coarse.repeat(s // 8, axis=2).repeat(s // 8, axis=3)
        self.prototypes = up  # (C, P, s, s, ch)

    def sample(self, n: int, rng: np.random.Generator, classes=None):
        cfg = self.cfg
        classes = np.asarray(classes if classes is not None else np.arange(cfg.num_classes))
        labels = rng.choice(classes, size=n)
        proto_idx = rng.integers(0, cfg.prototypes_per_class, size=n)
        imgs = self.prototypes[labels, proto_idx].copy()  # (n, s, s, ch)
        # random circular shifts (translation invariance pressure)
        for i in range(n):
            dx, dy = rng.integers(-cfg.max_shift, cfg.max_shift + 1, size=2)
            imgs[i] = np.roll(np.roll(imgs[i], dx, axis=0), dy, axis=1)
        imgs += rng.normal(scale=cfg.noise, size=imgs.shape).astype(np.float32)
        return imgs.astype(np.float32), labels.astype(np.int32)

    # -- the paper's §IV.A non-IID partition ---------------------------------

    def paper_partition(
        self,
        num_agents: int = 16,
        min_classes: int = 5,
        max_classes: int = 8,
        min_samples: int = 1500,
        max_samples: int = 2000,
        seed: int = 0,
    ):
        """Returns per-agent train sets: list of (images, labels)."""
        rng = np.random.default_rng(seed)
        shards = []
        for _ in range(num_agents):
            n_cls = rng.integers(min_classes, max_classes + 1)
            classes = rng.choice(self.cfg.num_classes, size=n_cls, replace=False)
            n = int(rng.integers(min_samples, max_samples + 1))
            shards.append(self.sample(n, rng, classes=classes))
        return shards

    def test_set(self, n: int = 2000, seed: int = 10_000):
        rng = np.random.default_rng(seed)
        return self.sample(n, rng)


def agent_minibatches(shards, batch_size: int, epoch_seed: int):
    """One epoch of aligned per-agent minibatches.

    Each agent iterates its own shard (shuffled per epoch); the epoch length
    is the MINIMUM number of full batches across agents so the returned array
    stacks to (n_batches, K, batch, ...)."""
    rng = np.random.default_rng(epoch_seed)
    K = len(shards)
    n_batches = min(len(x) // batch_size for x, _ in shards)
    imgs, labs = [], []
    for x, y in shards:
        perm = rng.permutation(len(x))[: n_batches * batch_size]
        imgs.append(x[perm].reshape(n_batches, batch_size, *x.shape[1:]))
        labs.append(y[perm].reshape(n_batches, batch_size))
    return {
        "images": np.stack(imgs, axis=1),  # (n_batches, K, B, s, s, ch)
        "labels": np.stack(labs, axis=1),  # (n_batches, K, B)
    }
