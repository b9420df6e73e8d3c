"""Time to first token, 90th percentile (nearest rank) over every request
due in the window: from its due time in the schedule to the return of the
step that carried its first token. A request refused, failed or still
without a token when the run stops following it counts as missing every
limit and sits at the top."""
from portbench.harness.record import percentile


def read(run):
    due = run.window_requests()
    if not due:
        return None
    waits = [r.first - r.due if r.first is not None and r.outcome != "error"
             else float("inf") for r in due]
    return percentile(waits, 90)
