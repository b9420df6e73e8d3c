"""AdamW as the configuration states it: clip by the global norm (scale
``max_norm / norm`` only when the norm reaches ``max_norm``), Adam with b1
0.9, b2 0.999, eps 1e-8 outside the square root and bias correction,
decoupled decay added to the update, a linear warmup to the peak rate and a
cosine to 0 read at the step count before the increment."""
from __future__ import annotations

import math
from typing import Dict, List

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def learning_rate(count: int, peak: float, warmup: int, total: int) -> float:
    if count < warmup:
        return peak * count / warmup
    span = total - warmup
    done = min(count - warmup, span)
    return peak * 0.5 * (1.0 + math.cos(math.pi * done / span))


class AdamW:
    def __init__(self, params: List[torch.Tensor], settings: Dict) -> None:
        self.params = params
        self.settings = settings
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        s = self.settings
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clip = 1.0 if float(norm) < s["max_grad_norm"] else \
            s["max_grad_norm"] / norm
        lr = learning_rate(self.count, s["learning_rate"], s["warmup_steps"],
                           s["total_steps"])
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g * clip
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            update.add_(p, alpha=s["weight_decay"])
            p.add_(update, alpha=-lr)
