"""Replicated token server (copied) and device-side attestation (ported)."""
