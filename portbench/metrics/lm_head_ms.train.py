"""Mean device time of the LM head in a train step: its forward and its
backward (the ``train.head_fwd`` and ``train.head_bwd`` spans that the
port's train step records in its process tracer), over the window's steps
that neither the harness traced nor a profiler recorded, ms. None where
the step records no such spans.

A ``train.step`` span starts on the wall clock at the step's entry; it is
taken to the step of ``run.steps`` (host ``perf_counter``) whose start
and end hold it, through the offset between the two clocks, read once."""
import time


def window_phases(run):
    """Per kept step, the durations of its phase spans: [{name: ms}]."""
    from tensorhive_tpu_torch.observability import get_tracer

    spans = get_tracer().recent(kind="train")
    if not spans or not run.steps:
        return []
    offset = time.time() - time.perf_counter()
    children = {}
    for span in spans:
        if span["parentId"] is not None:
            children.setdefault(span["parentId"], {})[span["name"]] = (
                span["durationMs"])
    kept = []
    for span in spans:
        if (span["name"] != "train.step"
                or span["attrs"].get("profiled") != "0"):
            continue
        start = span["startTs"] - offset
        step = next((step for step in run.steps
                     if step[0] <= start <= step[1]), None)
        if step is not None and not step[3]:
            kept.append(children.get(span["spanId"], {}))
    return kept


def phase_ms(run, phases):
    """Mean over the kept steps of the sum of ``phases``' spans, ms."""
    steps = window_phases(run)
    if not steps:
        return None
    return sum(sum(step.get(f"train.{phase}", 0.0) for phase in phases)
               for step in steps) / len(steps)


def read(run):
    return phase_ms(run, ("head_fwd", "head_bwd"))
