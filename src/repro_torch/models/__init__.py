"""Dense attention stack (gemma3) ported from ``repro.models``."""
