"""User-facing REST API (aiohttp) of a validator service.

This package's own copy of ``dvdx_tpu/network/api.py``: the same endpoints,
status codes and JSON bodies.

  POST /submit_prompt {request_id, prompt}  verify the prompt against the
        ledger's commitment and attach it, after waiting (<= submit_wait_s)
        for the deposit to be seen
  GET  /status/<id>      the request's lifecycle state
  GET  /result/<id>      the validator's results JSON (video paths -> URLs)
  GET  /videos/<file>    mp4 serving
  POST /refund/<id>      manual refund of a request still pending
  GET  /health
  GET  /requests         every tracked request joined with results on disk
  GET  /weights          the score book's weights (and the ledger's epoch)
  GET  /, /status.html   the repository's ``frontend/`` pages
plus what a chainless deployment needs:
  POST /register {pubkey, address, role, stake, platform, timestamp,
        signature}  neuron registration; the Ed25519 signature over
        ``verify.proof.registration_message`` binds the platform pin and the
        stake to the key owner
  GET  /registry         the neuron table for miners' sync loops
  POST /deposit {user, request_id, prompt_hash, amount[, pubkey, signature]}
        the dev faucet standing in for an on-chain depositAndCommit
"""

from __future__ import annotations

import asyncio
import glob
import json
import os
import time

from aiohttp import web

from ..verify.proof import verify_registration_signature, verify_signature
from .base import Registry
from .deposit_listener import DepositListener
from .ledger import Ledger, LedgerError

# the repository's web pages, beside the package
FRONTEND = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "frontend")


def create_app(ledger: Ledger, listener: DepositListener, registry: Registry,
               results_dir: str = "generated_videos",
               submit_wait_s: float = 120.0) -> web.Application:
    app = web.Application()

    def cors(resp: web.StreamResponse) -> web.StreamResponse:
        resp.headers["Access-Control-Allow-Origin"] = "*"
        return resp

    async def submit_prompt(request: web.Request):
        try:
            body = await request.json()
        except Exception:
            return cors(web.json_response({"error": "invalid JSON"}, status=400))
        rid = body.get("request_id")
        prompt = body.get("prompt")
        if not rid or not prompt:
            return cors(web.json_response(
                {"error": "request_id and prompt required"}, status=400))
        # wait for the deposit event to be seen
        deadline = time.time() + submit_wait_s
        while listener.status_of(rid) is None and time.time() < deadline:
            await asyncio.sleep(0.1)
        if listener.status_of(rid) is None:
            return cors(web.json_response(
                {"error": "no deposit found for request"}, status=404))
        if not listener.attach_prompt(rid, prompt):
            return cors(web.json_response(
                {"error": "prompt does not match on-ledger commitment"},
                status=400))
        return cors(web.json_response({"status": "accepted", "request_id": rid}))

    async def status(request: web.Request):
        rid = request.match_info["rid"]
        entry = listener.status_of(rid)
        if entry is None:
            return cors(web.json_response({"error": "unknown request"}, status=404))
        return cors(web.json_response({
            "request_id": rid, "status": entry["status"],
            "has_prompt": bool(entry["prompt"]),
        }))

    async def result(request: web.Request):
        rid = request.match_info["rid"]
        path = os.path.join(results_dir, f"results_{rid}.json")
        if not os.path.exists(path):
            return cors(web.json_response({"error": "no results yet"}, status=404))
        with open(path) as f:
            data = json.load(f)
        # rewrite any video paths to URLs
        for m in data.get("miners", {}).values():
            if "video_path" in m:
                m["video_url"] = f"/videos/{os.path.basename(m['video_path'])}"
        return cors(web.json_response(data))

    async def videos(request: web.Request):
        fname = os.path.basename(request.match_info["fname"])
        path = os.path.join(results_dir, fname)
        if not os.path.exists(path):
            return cors(web.json_response({"error": "not found"}, status=404))
        return cors(web.FileResponse(path))

    async def refund(request: web.Request):
        rid = request.match_info["rid"]
        try:
            if listener.status_of(rid) is not None:
                # known to the listener: refund only while still 'pending'
                # (a claimed round must finish and pay its miners)
                if not listener.try_refund(rid):
                    return cors(web.json_response(
                        {"error": "request is processing or finished"},
                        status=409))
            else:
                ledger.refund_unused("validator", rid)
            return cors(web.json_response({"status": "refunded"}))
        except LedgerError as e:
            return cors(web.json_response({"error": str(e)}, status=400))

    async def health(_request):
        return cors(web.json_response({
            "status": "ok",
            "active_requests": len(listener.active_requests),
            "miners": len(registry.miners()),
            "block": ledger.block,
        }))

    async def register(request: web.Request):
        body = await request.json()
        try:
            stake = int(body.get("stake", 0))
            if not 0 <= stake < 2**63:
                raise ValueError(f"stake out of range: {stake}")
            pubkey = bytes.fromhex(body["pubkey"])
            address = body["address"]
            role = body.get("role", "miner")
            if not isinstance(address, str) or not isinstance(role, str):
                raise ValueError("address/role must be strings")
            platform = str(body.get("platform", ""))
            # the registry entry (address routing + the platform pin that
            # decides bitwise-vs-tolerance verification) belongs to the key
            # owner: require an Ed25519 signature over the canonical
            # registration message (an unauthenticated pin would let anyone
            # downgrade a miner's regime). The message binds stake (a
            # replayer cannot attach its own) and a timestamp (a captured
            # request stops replaying after REGISTRATION_MAX_AGE_S).
            sig = bytes.fromhex(body.get("signature", ""))
            ts = int(body.get("timestamp", 0))
            if not verify_registration_signature(pubkey, address,
                                                 role, platform, stake, ts,
                                                 sig):
                return cors(web.json_response(
                    {"error": "invalid or stale registration signature"},
                    status=403))
            uid = registry.register(pubkey, address, role, stake,
                                    platform=platform)
            # dev-faucet semantics: mirror the declared stake onto the ledger
            # so record_submission's staked-miner requirement holds (a real
            # deployment replaces this with an on-chain stake transaction)
            account = f"miner-{uid}"
            if body.get("role", "miner") == "miner" and \
                    stake > ledger.stake_of(account):
                delta = stake - ledger.stake_of(account)
                ledger.mint(account, delta)
                ledger.stake(account, delta)
        except (KeyError, ValueError, TypeError, OverflowError,
                AttributeError) as e:
            # a public endpoint must map hostile JSON to 400, not 500:
            # TypeError/AttributeError for wrong value types, OverflowError
            # for out-of-range ints that slip past validation
            return cors(web.json_response({"error": str(e)}, status=400))
        return cors(web.json_response({"uid": uid}))

    async def registry_snapshot(_request):
        return cors(web.Response(text=registry.to_json(),
                                 content_type="application/json"))

    async def deposit(request: web.Request):
        body = await request.json()
        try:
            user = body["user"]
            amount = int(body["amount"])
            prompt_hash = bytes.fromhex(body["prompt_hash"])  # validate first
            rid = body["request_id"]
            # wallet-grade commit signing: when the client supplies an
            # Ed25519 pubkey + signature over the canonical commitment
            # message, the deposit account is bound to that key (refunds and
            # results belong to the key holder, not to a claimed name)
            if body.get("pubkey") or body.get("signature"):
                pub = bytes.fromhex(body["pubkey"])
                sig = bytes.fromhex(body["signature"])
                msg = f"dvdx-deposit|{rid}|{prompt_hash.hex()}|{amount}".encode()
                if not verify_signature(pub, msg, sig):
                    return cors(web.json_response(
                        {"error": "bad deposit signature"}, status=403))
                user = f"ed25519:{pub.hex()}"
            ledger.mint(user, amount)
            try:
                ledger.deposit_and_commit(user, rid, prompt_hash, amount)
            except LedgerError:
                ledger.burn(user, amount)  # roll the faucet mint back
                raise
        except (KeyError, ValueError, LedgerError) as e:
            return cors(web.json_response({"error": str(e)}, status=400))
        return cors(web.json_response({"status": "deposited", "user": user}))

    async def index(_request):
        page = os.path.join(FRONTEND, "index.html")
        if os.path.exists(page):
            return web.FileResponse(page)
        return web.json_response({"service": "dvdx validator API"})

    async def status_page(_request):
        # per-request score / spot-check breakdown and debug view
        page = os.path.join(FRONTEND, "status.html")
        if os.path.exists(page):
            return web.FileResponse(page)
        return web.json_response({"error": "status page not installed"}, status=404)

    async def weights(_request):
        # weight emission view: kappa-clipped normalised and u16 weights,
        # plus the ledger's epoch and vector (what Validator.emit_weights
        # records each round)
        sb = app.get("scorebook")
        body = {"weights": {}, "u16": {}}
        if sb is not None:
            body = {"weights": sb.weights(), "u16": sb.weights_u16()}
        if ledger is not None and hasattr(ledger, "weights_epoch") \
                and not callable(ledger.weights_epoch):
            body["onchain"] = {"epoch": ledger.weights_epoch,
                               "weights": dict(ledger.weights)}
        return cors(web.json_response(body))

    async def requests_list(_request):
        """Live-rounds feed for the frontend (status.html polls this): every
        request the deposit listener tracks, joined with the on-disk round
        results (miner count / top score / cheats) once a round completes."""
        out = listener.all_requests()
        for path in glob.glob(os.path.join(results_dir, "results_*.json")):
            rid = os.path.basename(path)[len("results_"):-len(".json")]
            entry = out.setdefault(rid, {"status": "completed"})
            try:
                with open(path) as f:
                    data = json.load(f)
                miners = data.get("miners", {})
                scores = [m.get("score", 0.0) for m in miners.values()]
                entry["miners"] = len(miners)
                entry["top_score"] = max(scores) if scores else 0.0
                entry["cheats"] = sum(1 for m in miners.values()
                                      if m.get("cheat"))
                entry["has_results"] = True
            except Exception:
                entry["has_results"] = False
        return cors(web.json_response(
            {"requests": out, "count": len(out)}))

    app.router.add_get("/", index)
    app.router.add_get("/requests", requests_list)
    app.router.add_get("/status.html", status_page)
    app.router.add_get("/weights", weights)
    app.router.add_post("/submit_prompt", submit_prompt)
    app.router.add_get("/status/{rid}", status)
    app.router.add_get("/result/{rid}", result)
    app.router.add_get("/videos/{fname}", videos)
    app.router.add_post("/refund/{rid}", refund)
    app.router.add_get("/health", health)
    app.router.add_post("/register", register)
    app.router.add_get("/registry", registry_snapshot)
    app.router.add_post("/deposit", deposit)
    return app


async def serve_api(app: web.Application, host: str = "127.0.0.1",
                    port: int = 0) -> tuple:
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    actual_port = site._server.sockets[0].getsockname()[1]
    return runner, actual_port
