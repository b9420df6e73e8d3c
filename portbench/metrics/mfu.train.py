"""The train step's share of the card's bf16 peak: model FLOPs of a
trained token (recomputation not counted; ``harness/arith.py``) times the
window's trained tokens per second, in percent."""
from portbench.harness import arith


def read(run):
    if not run.steps:
        return None
    shape = arith.Shape.of(run.config)
    seq = run.cell["traffic"]["seq_len"]
    tokens = sum(step[2] for step in run.steps)
    rate = tokens / (run.steps[-1][1] - run.steps[0][0])
    return (100.0 * arith.train_flops_per_token(shape, seq) * rate
            / arith.PEAK_BF16_FLOPS)
