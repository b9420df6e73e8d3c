"""The prefix cache's hits over its lookups in the window: the difference
of ``SlotEngine.stats()``'s ``prefixHits`` and ``prefixMisses`` across it,
in percent."""


def read(run):
    before, after = run.stats_before, run.stats_after
    if not before or not after:
        return None
    hits = after["prefixHits"] - before["prefixHits"]
    misses = after["prefixMisses"] - before["prefixMisses"]
    if hits + misses == 0:
        return None
    return 100.0 * hits / (hits + misses)
