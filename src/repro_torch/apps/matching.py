"""Financial order matching engine — the Liquibook analog of §7.1.

A price-time-priority limit order book.  Requests are 32 B (like the paper's
Liquibook workload); responses grow with the number of matched orders
(32 B – 288 B in the paper).

Request wire format:
    b"B"/b"S" + order_id(8) + price(8) + qty(8) + pad -> BUY / SELL limit
Response: sequence of fills ``(maker_id, price, qty)`` packed 24 B each,
prefixed by a 8 B fill count (so a no-fill ack is 8 B + padding to 32 B).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

from repro_torch.core.consensus import App


def order_req(side: str, order_id: int, price: int, qty: int) -> bytes:
    body = (b"B" if side == "buy" else b"S") + struct.pack(
        "<QQQ", order_id, price, qty)
    return body.ljust(32, b"\x00")


class MatchingEngineApp(App):
    def __init__(self) -> None:
        # price -> FIFO list of (order_id, qty); bids and asks kept sorted
        self.bids: List[Tuple[int, int, int]] = []  # (-price, seq, ...) heap-free impl
        self.asks: List[Tuple[int, int, int]] = []
        self._seq = 0
        self.fills = 0

    def apply(self, req: bytes) -> bytes:
        side = req[:1]
        order_id, price, qty = struct.unpack_from("<QQQ", req, 1)
        fills: List[Tuple[int, int, int]] = []
        self._seq += 1
        if side == b"B":
            # match against asks with price <= limit
            while qty > 0 and self.asks and self.asks[0][0] <= price:
                ap, aseq, (aid, aqty) = self.asks[0][0], self.asks[0][1], self.asks[0][2]
                take = min(qty, aqty)
                fills.append((aid, ap, take))
                qty -= take
                if take == aqty:
                    self.asks.pop(0)
                else:
                    self.asks[0] = (ap, aseq, (aid, aqty - take))
            if qty > 0:
                self.bids.append((-price, self._seq, (order_id, qty)))
                self.bids.sort()
        elif side == b"S":
            while qty > 0 and self.bids and -self.bids[0][0] >= price:
                bp, bseq, (bid, bqty) = -self.bids[0][0], self.bids[0][1], self.bids[0][2]
                take = min(qty, bqty)
                fills.append((bid, bp, take))
                qty -= take
                if take == bqty:
                    self.bids.pop(0)
                else:
                    self.bids[0] = (-bp, bseq, (bid, bqty - take))
            if qty > 0:
                self.asks.append((price, self._seq, (order_id, qty)))
                self.asks.sort()
        else:
            return b"ERR".ljust(32, b"\x00")
        self.fills += len(fills)
        out = struct.pack("<Q", len(fills))
        for mid, p, q in fills:
            out += struct.pack("<QQQ", mid, p, q)
        return out.ljust(32, b"\x00")

    def snapshot(self):
        return (tuple(self.bids), tuple(self.asks), self._seq, self.fills)

    def adopt(self, snap) -> None:
        bids, asks, seq, fills = snap
        self.bids = [tuple(b) for b in bids]
        self.asks = [tuple(a) for a in asks]
        self._seq = seq
        self.fills = fills
