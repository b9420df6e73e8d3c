"""The card's idle share in the profiled span: one minus the union of its
operations' intervals over the span, in percent."""
from portbench.harness.trace import idle_percent


def read(run):
    return idle_percent(run.profile)
