"""Replicated token server and trainer (copied); device-side attestation
and step builders (ported)."""
