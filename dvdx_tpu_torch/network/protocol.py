"""Wire protocol between miners, validators and users.

This package's own copy of ``dvdx_tpu/network/protocol.py``, byte for byte
on the wire: every message is a msgpack map (``"_type"`` first, then the
dataclass fields in declaration order) with raw-bytes payloads, framed as
MAGIC | u8 version | u32 length | payload. A request's Ed25519 signature
covers ``signing_bytes``, the wire encoding itself, so the two packages must
emit identical bytes: same field order, same defaults, and only Python
``int``, ``float``, ``bool``, ``str`` and ``bytes`` on the wire. numpy and
torch scalars are turned into those before packing (msgpack cannot pack
them, and their widths would change the signed bytes).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Tuple, Type

import msgpack

MAGIC = b"DVDX"
VERSION = 1


# --- framing ---------------------------------------------------------------


def frame(payload: bytes) -> bytes:
    """MAGIC | u8 version | u32 length | payload."""
    return MAGIC + struct.pack(">BI", VERSION, len(payload)) + payload


def unframe(buf: bytes) -> Tuple[bytes, bytes]:
    """-> (payload, rest). Raises ValueError on malformed frames."""
    if len(buf) < 9:
        raise ValueError("short frame")
    if buf[:4] != MAGIC:
        raise ValueError("bad magic")
    ver, ln = struct.unpack(">BI", buf[4:9])
    if ver != VERSION:
        raise ValueError(f"bad version {ver}")
    if len(buf) < 9 + ln:
        raise ValueError("truncated frame")
    return buf[9: 9 + ln], buf[9 + ln:]


# --- messages --------------------------------------------------------------

_REGISTRY: Dict[str, Type] = {}


def _message(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


def _plain(v):
    """A field value with numpy / torch scalars turned into Python ones,
    containers walked."""
    if isinstance(v, (bool, int, float, str, bytes)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {_plain(k): _plain(x) for k, x in v.items()}
    if getattr(v, "ndim", None) == 0 and hasattr(v, "item"):
        return v.item()
    raise TypeError(f"cannot put {type(v).__name__} on the wire")


def to_wire(msg) -> bytes:
    body = {"_type": type(msg).__name__}
    for f in dataclasses.fields(msg):
        body[f.name] = _plain(getattr(msg, f.name))
    return frame(msgpack.packb(body, use_bin_type=True))


def signing_bytes(msg) -> bytes:
    """The bytes a request's Ed25519 signature covers: its wire encoding with
    its own ``signature`` field blank, so every field is covered."""
    return to_wire(dataclasses.replace(msg, signature=b""))


def from_wire(data: bytes):
    payload, rest = unframe(data)
    if rest:
        raise ValueError("trailing bytes after frame")
    body = msgpack.unpackb(payload, raw=False, strict_map_key=False)
    tname = body.pop("_type", None)
    cls = _REGISTRY.get(tname)
    if cls is None:
        raise ValueError(f"unknown message type {tname!r}")
    fields = {f.name for f in dataclasses.fields(cls)}
    msg = cls(**{k: v for k, v in body.items() if k in fields})
    if hasattr(msg, "validate"):
        msg.validate()
    return msg


@_message
@dataclasses.dataclass
class InferenceRequest:
    request_id: str
    prompt: str
    negative_prompt: str = ""
    width: int = 576
    height: int = 320
    num_frames: int = 16
    fps: int = 8
    num_steps: int = 25
    guidance_scale: float = 7.5
    seed: int = 0                 # HMAC-derived by the validator
    challenge: bytes = b""        # 32-byte validator challenge
    validator_pubkey: bytes = b""
    # step-program identity: uncond / cond as two UNet calls instead of one
    # batched call; prover and verifier must run the same program
    cfg_split: bool = False
    issued_at: float = 0.0        # signing time; miners refuse stale requests
    signature: bytes = b""        # Ed25519 over signing_bytes(self)

    def validate(self):
        self.cfg_split = bool(self.cfg_split)
        for f in ("width", "height", "num_frames", "fps", "num_steps", "seed"):
            setattr(self, f, int(getattr(self, f)))
        if self.width <= 0 or self.height <= 0 or self.num_frames <= 0:
            raise ValueError("bad geometry")
        if self.num_steps <= 0 or self.num_steps > 1000:
            raise ValueError("bad num_steps")
        if self.challenge and len(self.challenge) != 32:
            raise ValueError("challenge must be 32 bytes")


@_message
@dataclasses.dataclass
class InferenceResponse:
    request_id: str
    status: str = "ok"            # ok | error
    error: str = ""
    video: bytes = b""            # mp4 (or raw container) bytes
    video_sha256: bytes = b""
    merkle_root: bytes = b""
    signature: bytes = b""
    miner_pubkey: bytes = b""
    challenge: bytes = b""        # echoed
    seed: int = 0                 # echoed
    num_steps: int = 0
    timesteps: List[int] = dataclasses.field(default_factory=list)
    latent_shape: List[int] = dataclasses.field(default_factory=list)  # (F, h, w, C)
    latent_dtype: str = "bfloat16"
    num_chunks: int = 0           # a chunked-strategy miner's committed chunk count
    platform: str = ""            # engine tag; the registry pin decides the regime
    gen_time_s: float = 0.0
    # advisory miner-side phase seconds (unsigned, observability only)
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)


@_message
@dataclasses.dataclass
class RevealRequest:
    request_id: str
    merkle_root: bytes
    leaf_indices: List[int]
    validator_pubkey: bytes = b""
    issued_at: float = 0.0
    signature: bytes = b""        # Ed25519 over signing_bytes(self)


@_message
@dataclasses.dataclass
class RevealResponse:
    request_id: str
    status: str = "ok"
    error: str = ""
    # per revealed leaf: (index, timestep, z_bytes, eps_bytes,
    #                     [(sibling_hash, is_right), ...])
    leaves: List[Tuple[int, int, bytes, bytes, List[Tuple[bytes, bool]]]] = (
        dataclasses.field(default_factory=list))


@_message
@dataclasses.dataclass
class Ping:
    nonce: int = 0


@_message
@dataclasses.dataclass
class Pong:
    nonce: int = 0
    pubkey: bytes = b""
    busy: bool = False
