"""Flip — the paper's toy application: reverses its input (§7.1)."""

from __future__ import annotations

from repro_torch.core.consensus import App


class FlipApp(App):
    def __init__(self) -> None:
        self.count = 0

    def apply(self, req: bytes) -> bytes:
        self.count += 1
        return req[::-1]

    def snapshot(self):
        return self.count

    def adopt(self, snap) -> None:
        self.count = snap
