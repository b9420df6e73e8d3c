"""The decode step's share of the card's peak: the least time of the
window's decode-only ticks (for each, the larger of its FLOPs at the bf16
peak and its bytes at HBM bandwidth: every weight once, plus the K/V that
its tokens' contexts need; ``harness/arith.py``) over their measured
length (flight recorder; traced ticks left out), in percent."""
from portbench.harness import arith


def read(run):
    shape = arith.Shape.of(run.config)
    page = run.config["serving"]["page_size"]
    bound = spent = 0.0
    for tick in run.ticks:
        row = tick.get("row")
        if (not row or row["admitted"] or row["prefillChunks"]
                or not tick["contexts"] or tick["traced"]):
            continue
        bound += arith.decode_tick_bound_s(tick["contexts"], shape, page)
        spent += row["durationS"]
    if spent <= 0:
        return None
    return 100.0 * bound / spent
