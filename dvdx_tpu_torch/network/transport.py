"""In-process transport between neurons, with WAN emulation.

This package's own copy of ``dvdx_tpu/network/transport.py``'s
``MockTransport``: an address -> handler table whose messages still
round-trip through the wire format (``protocol.to_wire`` / ``from_wire``),
with emulated latency, jitter, bandwidth and drops (``WANProfile``,
``WAN_PRESETS``). Each handler runs in the event loop's default thread pool,
so concurrent requests to several miners run in several threads; on one
CUDA card their kernels all go to torch's current stream, the legacy
default stream of every thread, and so run one after another.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
from typing import Callable, Dict, Optional

from . import protocol as P


@dataclasses.dataclass
class WANProfile:
    """Emulated consumer-network profile (reference presets
    `full_experiments_ZeroscopeXL.sh:23-33`)."""

    name: str = "ideal"
    bandwidth_mbps: float = 0.0   # 0 = infinite
    rtt_ms: float = 0.0
    jitter_ms: float = 0.0
    drop_rate: float = 0.0

    def delay_s(self, payload_bytes: int, rng: random.Random) -> float:
        d = 0.0
        if self.rtt_ms > 0:
            d += max(0.0, rng.gauss(self.rtt_ms, self.jitter_ms)) / 1e3
        if self.bandwidth_mbps > 0:
            d += payload_bytes * 8 / (self.bandwidth_mbps * 1e6)
        return d


WAN_PRESETS = {
    "ideal": WANProfile("ideal"),
    "wifi": WANProfile("wifi", bandwidth_mbps=500.0, rtt_ms=3.01, jitter_ms=3.53),
    "ethernet": WANProfile("ethernet", bandwidth_mbps=1000.0, rtt_ms=0.12, jitter_ms=0.06),
}


class TransportError(Exception):
    pass


class MockTransport:
    """address -> handler; messages round-trip through the real wire format."""

    def __init__(self, wan: Optional[WANProfile] = None, seed: int = 0):
        self._handlers: Dict[str, Callable] = {}
        self.wan = wan or WAN_PRESETS["ideal"]
        self._rng = random.Random(seed)
        self.stats = {"requests": 0, "bytes_sent": 0, "bytes_received": 0,
                      "emulated_delay_s": 0.0, "drops": 0}

    def serve(self, address: str, handler: Callable):
        """handler: (msg) -> msg (sync)."""
        self._handlers[address] = handler

    def remove(self, address: str):
        self._handlers.pop(address, None)

    async def request(self, address: str, msg, timeout_s: float = 300.0):
        self.stats["requests"] += 1
        handler = self._handlers.get(address)
        if handler is None:
            raise TransportError(f"no neuron serving at {address}")
        wire = P.to_wire(msg)
        self.stats["bytes_sent"] += len(wire)
        if self._rng.random() < self.wan.drop_rate:
            self.stats["drops"] += 1
            raise asyncio.TimeoutError(f"emulated drop to {address}")

        delay = self.wan.delay_s(len(wire), self._rng)

        async def _run():
            decoded = P.from_wire(wire)
            reply = await asyncio.get_event_loop().run_in_executor(
                None, handler, decoded)
            reply_wire = P.to_wire(reply)
            d2 = self.wan.delay_s(len(reply_wire), self._rng)
            self.stats["emulated_delay_s"] += delay + d2
            await asyncio.sleep(delay + d2)
            self.stats["bytes_received"] += len(reply_wire)
            return P.from_wire(reply_wire)

        return await asyncio.wait_for(_run(), timeout=timeout_s)
