"""Trained tokens a card delivers: the tokens of every whole step of the
window over the time from the first step's start to the last step's
synchronised end."""


def read(run):
    if not run.steps:
        return None
    tokens = sum(step[2] for step in run.steps)
    return tokens / (run.steps[-1][1] - run.steps[0][0])
