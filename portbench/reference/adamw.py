"""AdamW (Loshchilov & Hutter) with decoupled weight decay, as the training
configuration states it: ``p -= lr * wd * p``; ``m = b1 m + (1 - b1) g``;
``v = b2 v + (1 - b2) g^2``; ``p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 -
b2^t)) + eps)``, every weight updated at every step."""

from __future__ import annotations

import torch


class AdamW:
    def __init__(self, weights: dict, train: dict) -> None:
        self.w = weights
        self.lr, self.wd = train["learning_rate"], train["weight_decay"]
        self.b1, self.b2 = train["betas"]
        self.eps = train["eps"]
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.v = {k: torch.zeros_like(v) for k, v in weights.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in self.w.items():
            g = grads[k]
            p.mul_(1.0 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
