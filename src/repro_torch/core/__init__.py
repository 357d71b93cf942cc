"""uBFT protocol layer, copied from ``repro.core`` (imports rewritten)."""
