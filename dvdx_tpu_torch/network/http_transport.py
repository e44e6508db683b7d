"""HTTP transport: neurons over aiohttp with binary frames.

This package's own copy of ``dvdx_tpu/network/http_transport.py``, the same
route and the same wire: a neuron serves ``POST /dvdx`` whose bodies are
length-prefixed msgpack frames (``protocol.to_wire``), so a miner or
validator of either package reaches one of the other.

The handler runs on a thread of the event loop's default executor. A thread
has its own current CUDA stream (torch's default stream of the device unless
it sets another), and the kernel wrappers launch on the caller's current
stream, so a miner's generation queues on that thread's stream.

Server: ``serve_neuron(handler, host, port)`` -> (aiohttp AppRunner, port)
Client: ``HttpTransport().request("host:port", msg)``
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from aiohttp import ClientSession, ClientTimeout, web

from . import protocol as P

ROUTE = "/dvdx"
HEALTH = "/health"


async def serve_neuron(handler: Callable, host: str = "127.0.0.1",
                       port: int = 0) -> tuple:
    """Serve a neuron handler. Returns (runner, actual_port)."""

    async def post(request: web.Request) -> web.Response:
        body = await request.read()
        try:
            msg = P.from_wire(body)
        except Exception as e:
            return web.Response(status=400, text=f"bad frame: {e}")
        try:
            reply = await asyncio.get_running_loop().run_in_executor(None, handler, msg)
        except Exception as e:
            return web.Response(status=500, text=f"{type(e).__name__}: {e}")
        return web.Response(body=P.to_wire(reply),
                            content_type="application/octet-stream")

    async def health(_request):
        return web.json_response({"status": "ok"})

    app = web.Application(client_max_size=1024**3)
    app.router.add_post(ROUTE, post)
    app.router.add_get(HEALTH, health)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    actual_port = site._server.sockets[0].getsockname()[1]
    return runner, actual_port


class HttpTransport:
    """Client side. Addresses are 'host:port'."""

    def __init__(self):
        self._session: Optional[ClientSession] = None
        self.stats = {"requests": 0, "bytes_sent": 0, "bytes_received": 0}

    async def _sess(self) -> ClientSession:
        if self._session is None or self._session.closed:
            self._session = ClientSession()
        return self._session

    async def request(self, address: str, msg, timeout_s: float = 300.0):
        sess = await self._sess()
        wire = P.to_wire(msg)
        self.stats["requests"] += 1
        self.stats["bytes_sent"] += len(wire)
        url = f"http://{address}{ROUTE}"
        async with sess.post(url, data=wire,
                             timeout=ClientTimeout(total=timeout_s)) as resp:
            body = await resp.read()
            if resp.status != 200:
                raise RuntimeError(f"{address} -> {resp.status}: {body[:200]!r}")
            self.stats["bytes_received"] += len(body)
            return P.from_wire(body)

    async def close(self):
        if self._session and not self._session.closed:
            await self._session.close()
