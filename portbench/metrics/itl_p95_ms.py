"""Inter-token latency, 95th percentile (nearest rank) over every gap
between two consecutive tokens of a request when both fall in the window."""
from portbench.harness.record import percentile


def read(run):
    start, end = run.window
    gaps = []
    for request in run.requests:
        times = request.times
        for before, after in zip(times, times[1:]):
            if start <= before and after <= end:
                gaps.append((after - before) * 1e3)
    return percentile(gaps, 95)
