"""Output tokens a card delivers: every token whose step returned inside
the window, over the window (which ends with the last step that began in
it)."""


def read(run):
    start, end = run.window
    if end <= start:
        return None
    count = sum(1 for request in run.requests for t in request.times
                if start < t <= end)
    return count / (end - start)
