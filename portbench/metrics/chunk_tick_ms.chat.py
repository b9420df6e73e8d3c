"""Mean length of a scheduler tick that carried prefill chunks, from the
flight recorder (``durationS`` of the window's ticks with
``prefillChunks`` > 0; traced ticks left out), ms."""


def read(run):
    ticks = [t["row"]["durationS"] for t in run.ticks
             if t.get("row") and t["row"]["prefillChunks"] > 0
             and not t["traced"]]
    if not ticks:
        return None
    return 1e3 * sum(ticks) / len(ticks)
