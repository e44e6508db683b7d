"""Video encode / decode.

This package's own copy of ``dvdx_tpu/utils/video_io.py``, with the same
container bytes: mp4 (``mp4v``) through cv2 where cv2 imports, else the raw
``DVDXRAW1`` container (magic, five big-endian u32 F, H, W, C, fps, then the
uint8 frames). mp4 is lossy and codec-dependent, so a proof signs the exact
bytes a miner produced; the validator compares digests and never
re-encodes.
"""

from __future__ import annotations

import os
import struct
import tempfile

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False

RAW_MAGIC = b"DVDXRAW1"


def encode_mp4(frames_uint8: np.ndarray, fps: int = 8) -> bytes:
    """(F, H, W, 3) RGB uint8 -> mp4 bytes (falls back to raw container)."""
    if _HAS_CV2:
        f, h, w, _ = frames_uint8.shape
        with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as tmp:
            path = tmp.name
        try:
            writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                     fps, (w, h))
            if writer.isOpened():
                for frame in frames_uint8:
                    writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
                writer.release()
                with open(path, "rb") as fh:
                    data = fh.read()
                if data:
                    return data
        finally:
            if os.path.exists(path):
                os.unlink(path)
    return encode_raw(frames_uint8, fps)


def encode_raw(frames_uint8: np.ndarray, fps: int = 8) -> bytes:
    f, h, w, c = frames_uint8.shape
    header = RAW_MAGIC + struct.pack(">IIIII", f, h, w, c, fps)
    return header + np.ascontiguousarray(frames_uint8).tobytes()


def decode_video(data: bytes) -> np.ndarray:
    """mp4/raw bytes -> (F, H, W, 3) RGB uint8."""
    if data[:8] == RAW_MAGIC:
        f, h, w, c, _fps = struct.unpack(">IIIII", data[8:28])
        arr = np.frombuffer(data[28:], np.uint8)
        return arr.reshape(f, h, w, c).copy()
    if not _HAS_CV2:
        raise RuntimeError("cv2 unavailable and data is not a raw container")
    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as tmp:
        tmp.write(data)
        path = tmp.name
    try:
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        if not frames:
            raise ValueError("no frames decoded")
        return np.stack(frames)
    finally:
        os.unlink(path)
