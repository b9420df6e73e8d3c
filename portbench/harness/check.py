"""How ``correct`` is decided: the program's outputs against the plain
reference, on the benchmark's own weights and inputs.

Serving: a sample of the finished requests, drawn from the seed with the
longest among them; the reference runs once over each prompt and its
served tokens, and the number compared is the widest gap by which a served
token's logit lies below the reference's best at its position. The control
(``--control fp8``) reads, at the same positions, the gap of the token that
the reference computed in fp8 puts first.

Training: the losses of the first steps, the first gradient as the
optimizer got it (its first moment after one step, over 1 − b1), and each
leaf's change over those steps; the gradient and the change compared leaf
by leaf as the gap between the two norms over the reference's norm of the
leaf or of the median leaf, whichever is larger. Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone and are left out of the change.
"""
from __future__ import annotations

from statistics import median
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import weights
from .arith import Shape
from .record import Check, Request
from ..reference import model as reference


def sample(requests: Sequence[Request], rng: np.random.Generator,
           requests_at_least: int, tokens_at_least: int) -> List[Request]:
    """The finished request with the most served tokens, then others in an
    order drawn from the seed until the sample holds both counts."""
    done = [r for r in requests if r.outcome == "completed" and r.tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), r.prompt_len))
    chosen = [longest]
    others = [r for r in done if r is not longest]
    for index in rng.permutation(len(others)):
        if (len(chosen) >= requests_at_least
                and sum(len(r.tokens) for r in chosen) >= tokens_at_least):
            break
        chosen.append(others[int(index)])
    return chosen


def verify_served(context, result, chosen: Sequence[Request]) -> None:
    """The sample's served tokens against the reference: ``logit_gap``,
    or under ``--control`` the control's gap (the program's is logged)."""
    import sys

    limits = context.spec.cell["check"]["limits"]
    wanted = context.spec.cell["check"]["sample"]["tokens_at_least"]
    served = sum(len(r.tokens) for r in chosen)
    if served < wanted:
        result.errors.append(f"the finished requests hold {served} served "
                             f"tokens, fewer than the {wanted} compared")
        if not chosen:
            return
    readings = served_gaps(context.shape, context.spec.config, context.seed,
                           context.device, chosen,
                           control=context.args.control)
    print(f"portbench: compared {len(chosen)} requests, {served} served "
          f"tokens; program logit_gap {readings['logit_gap']!r}",
          file=sys.stderr)
    key = "control_gap" if context.args.control else "logit_gap"
    if "control_gap" in readings:
        print(f"portbench: control_gap {readings['control_gap']!r}",
              file=sys.stderr)
    result.checks["logit_gap"] = Check(readings[key], limits["logit_gap"])


def _serving_weights(shape: Shape, config: Dict, seed: int,
                     device: torch.device):
    dtype = getattr(torch, config["serving"]["dtype"])

    def load_layer(index: int) -> Dict:
        block = weights.layer(shape, seed, index, device, dtype)
        return {name: ({"scale": leaf["scale"].float()}
                       if isinstance(leaf, dict) else leaf.float())
                for name, leaf in block.items()}

    embed = weights.embedding(shape, seed, device, dtype).float()
    head = weights.head(shape, seed, device, dtype).float()
    return load_layer, embed, head


def served_gaps(shape: Shape, config: Dict, seed: int,
                device: torch.device, chosen: Sequence[Request],
                control: Optional[str] = None) -> Dict[str, float]:
    """``logit_gap``: the widest gap of a served token below the
    reference's best; with ``control``, ``control_gap``: the same for the
    token the control puts first."""
    reference.exact_f32()
    load_layer, embed, head = _serving_weights(shape, config, seed, device)
    sequences = [r.prompt + r.tokens[:-1] for r in chosen]
    reads = [range(r.prompt_len - 1, r.prompt_len - 1 + len(r.tokens))
             for r in chosen]
    common = dict(layers=shape.layers, heads=shape.heads,
                  kv_heads=shape.kv_heads, theta=float(config["rope_theta"]),
                  eps=float(config["rms_norm_eps"]))
    final = torch.ones(shape.hidden, device=device)
    logits = reference.read_logits(sequences, reads, embed, load_layer,
                                   final_scale=final, head=head, **common)
    out = {}
    gaps = []
    for rows, request in zip(logits, chosen):
        served = torch.as_tensor(request.tokens, device=device).long()
        best = rows.max(dim=-1).values
        gaps.append(best - rows.gather(1, served[:, None])[:, 0])
    out["logit_gap"] = float(torch.cat(gaps).max())
    if control:
        lower = reference.read_logits(sequences, reads, embed, load_layer,
                                      final_scale=final, head=head,
                                      quant=control, **common)
        control_gaps = []
        for rows, low in zip(logits, lower):
            pick = low.argmax(dim=-1)
            control_gaps.append(rows.max(dim=-1).values
                                - rows.gather(1, pick[:, None])[:, 0])
        out["control_gap"] = float(torch.cat(control_gaps).max())
    return out


# -- training ------------------------------------------------------------------

def named(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every leaf of a param tree by its path (``blocks.3.wq``)."""
    if isinstance(tree, dict):
        out: Dict[str, torch.Tensor] = {}
        for key in sorted(tree):
            out.update(named(tree[key], f"{prefix}{key}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for index, item in enumerate(tree):
            out.update(named(item, f"{prefix}{index}."))
        return out
    return {prefix.rstrip("."): tree}


def change_norms(params: Dict, shape: Shape, seed: int,
                 device: torch.device) -> Dict[str, float]:
    """Each leaf's distance from its first value, drawn again from the
    seed one layer at a time."""
    out: Dict[str, float] = {}
    first = {"tok_embed": weights.embedding(shape, seed, device,
                                            torch.float32)}
    first["w_lm_head"] = weights.head(shape, seed, device, torch.float32)
    first["final_norm.scale"] = torch.ones(shape.hidden, device=device)
    now = named(params)
    for path, start in first.items():
        out[path] = float(torch.linalg.vector_norm(now[path].float() - start))
    del first
    for index in range(shape.layers):
        block = named(weights.layer(shape, seed, index, device,
                                    torch.float32), f"blocks.{index}.")
        for path, start in block.items():
            out[path] = float(torch.linalg.vector_norm(
                now[path].float() - start))
    return out


def norms(tree, scale: float = 1.0) -> Dict[str, float]:
    return {path: float(torch.linalg.vector_norm(leaf.float())) * scale
            for path, leaf in named(tree).items()}


def _leaf_gap(side: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Callable[[str], bool]] = None) -> float:
    paths = [p for p in ref if keep is None or keep(p)]
    floor = median([ref[p] for p in paths])
    return max(abs(side[p] - ref[p]) / max(ref[p], floor) for p in paths)


def train_gaps(side: Dict, ref: Dict) -> Dict[str, float]:
    """``loss_gap``: the widest relative gap of a step's loss;
    ``grad_gap`` and ``change_gap``: the worst leaf's gap of norms."""
    grads = ref["grad"]
    floor = median(grads.values())
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(side["loss"], ref["loss"])),
        "grad_gap": _leaf_gap(side["grad"], grads),
        "change_gap": _leaf_gap(side["change"], ref["change"],
                                lambda p: grads[p] >= 1e-3 * floor),
    }


def train_reference(shape: Shape, config: Dict, seed: int,
                    device: torch.device, steps: int,
                    batch: Callable[[int], torch.Tensor],
                    quant: Optional[str] = None) -> Dict:
    """The reference's readings over the first ``steps`` steps, a row at
    a time (each block recomputed in the backward)."""
    from ..reference.optim import B1, AdamW

    reference.exact_f32()
    settings = config["training"]
    tree = weights.params(shape, seed, device, torch.float32)
    leaves = named(tree)
    for path, leaf in leaves.items():
        leaves[path] = leaf.detach().requires_grad_()
    tree = _rebuild(tree, leaves)
    paths = list(leaves)
    optimizer = AdamW([leaves[p] for p in paths], settings)
    common = dict(heads=shape.heads, kv_heads=shape.kv_heads,
                  theta=float(config["rope_theta"]),
                  eps=float(config["rms_norm_eps"]), quant=quant)
    out: Dict = {"loss": []}
    for step in range(1, steps + 1):
        tokens = batch(step)
        count = tokens.shape[0] * (tokens.shape[1] - 1)
        total = 0.0
        for row in tokens:
            loss = reference.loss_sum(tree, row, **common) / count
            loss.backward()
            total += loss.detach().item()
        grads = [leaves[p].grad for p in paths]
        optimizer.step(grads)
        for p in paths:
            leaves[p].grad = None
        out["loss"].append(total)
        if step == 1:
            out["grad"] = {p: float(torch.linalg.vector_norm(mu)) / (1 - B1)
                           for p, mu in zip(paths, optimizer.mu)}
    with torch.no_grad():
        out["change"] = change_norms(tree, shape, seed, device)
    return out


def _rebuild(tree, leaves: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], leaves, f"{prefix}{key}.")
                for key in tree}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(item, leaves, f"{prefix}{index}.")
                for index, item in enumerate(tree)]
    return leaves[prefix.rstrip(".")]
