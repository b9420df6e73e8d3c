"""Mean wait phase of a scheduler tick that only decoded: the host's read
of the step's emitted tokens, which waits for the device (the flight
recorder's ``waitS``), over the window's decode-only ticks chosen as
``decode_tick_ms.decode`` chooses them (traced ticks left out), ms. None
where the recorder has no phase columns."""


def read(run):
    rows = [t["row"] for t in run.ticks
            if t.get("row") and t["row"]["admitted"] == 0
            and t["row"]["prefillChunks"] == 0
            and t["row"]["decodeSlots"] > 0 and not t["traced"]]
    if not rows or "waitS" not in rows[0]:
        return None
    return 1e3 * sum(row["waitS"] for row in rows) / len(rows)
