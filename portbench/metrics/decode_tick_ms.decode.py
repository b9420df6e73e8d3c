"""Mean length of a scheduler tick that only decoded (no admission, no
prefill chunk), from the flight recorder's ``durationS`` over the window's
ticks (traced ticks left out), ms."""


def read(run):
    ticks = [t["row"]["durationS"] for t in run.ticks
             if t.get("row") and t["row"]["admitted"] == 0
             and t["row"]["prefillChunks"] == 0
             and t["row"]["decodeSlots"] > 0 and not t["traced"]]
    if not ticks:
        return None
    return 1e3 * sum(ticks) / len(ticks)
