"""The harness: what every cell shares (set-up, clocks, the trace, the
frozen arithmetic, the result line)."""
