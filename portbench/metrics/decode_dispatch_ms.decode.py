"""Mean dispatch phase of a scheduler tick that only decoded: from the
engine entering the decode step's launches until every launch is enqueued
(the flight recorder's ``dispatchS``), over the window's decode-only ticks
chosen as ``decode_tick_ms.decode`` chooses them (traced ticks left out),
ms. None where the recorder has no phase columns."""


def read(run):
    rows = [t["row"] for t in run.ticks
            if t.get("row") and t["row"]["admitted"] == 0
            and t["row"]["prefillChunks"] == 0
            and t["row"]["decodeSlots"] > 0 and not t["traced"]]
    if not rows or "dispatchS" not in rows[0]:
        return None
    return 1e3 * sum(row["dispatchS"] for row in rows) / len(rows)
