"""Dependency-free MJPEG-in-AVI video writer.

The port's own copy of openfoam_tpp_tpu/post/avi.py (it imports nothing
of that package; the bytes written are the same). Without an ffmpeg
binary the reference's MP4 encode (`imageio`/`imageio-ffmpeg`,
the reference's main.py:612-725) is unavailable. Motion-JPEG inside a
RIFF/AVI container needs no codec library at all: each frame is a plain
JPEG (encoded with Pillow, a matplotlib dependency), and the container is
~100 lines of struct packing. The resulting .avi plays in
VLC/mpv/ffplay/browsers and imports into every editor.

Layout (OpenDML-free classic AVI 1.0, fine below 2 GB):

    RIFF('AVI '
      LIST('hdrl' avih LIST('strl' strh strf))
      LIST('movi' '00dc' <jpeg> ...)
      'idx1' index)
"""

from __future__ import annotations

import io
import struct


def _jpeg(frame, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def write_mjpeg_avi(path: str, frames, fps: int = 30,
                    quality: int = 90) -> str:
    """Encode an iterable of (H, W, 3) uint8 RGB frames to `path`."""
    jpegs = [_jpeg(f, quality) for f in frames]
    if not jpegs:
        raise ValueError("write_mjpeg_avi: no frames")
    h, w = frames[0].shape[:2]
    n = len(jpegs)
    max_size = max(len(j) for j in jpegs)

    avih = _chunk(b"avih", struct.pack(
        "<14I",
        int(1_000_000 / fps),  # dwMicroSecPerFrame
        max_size * fps,        # dwMaxBytesPerSec
        0,                     # dwPaddingGranularity
        0x10,                  # dwFlags: AVIF_HASINDEX
        n, 0, 1,               # totalFrames, initialFrames, streams
        max_size,              # dwSuggestedBufferSize
        w, h, 0, 0, 0, 0,
    ))
    strh = _chunk(b"strh", b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIII4h",
        0, 0, 0, 0,            # flags, priority, language, initialFrames
        1, fps,                # scale, rate  (fps = rate/scale)
        0, n,                  # start, length (frames)
        max_size,              # suggestedBufferSize
        0xFFFFFFFF, 0,         # quality, sampleSize
        0, 0, w, h,            # rcFrame
    ))
    strf = _chunk(b"strf", struct.pack(
        "<IiiHH4sIiiII",
        40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0,
    ))
    hdrl = _list(b"hdrl", avih + _list(b"strl", strh + strf))

    movi_parts = []
    idx = []
    offset = 4  # relative to the 'movi' fourcc
    for j in jpegs:
        ck = _chunk(b"00dc", j)
        movi_parts.append(ck)
        idx.append(struct.pack("<4sIII", b"00dc", 0x10, offset, len(j)))
        offset += len(ck)
    movi = _list(b"movi", b"".join(movi_parts))
    idx1 = _chunk(b"idx1", b"".join(idx))

    riff = _chunk(b"RIFF", b"AVI " + hdrl + movi + idx1)
    with open(path, "wb") as f:
        f.write(riff)
    return path


def _mp4_cv2(path: str, frames, fps: int) -> str:
    """MPEG-4 MP4 via OpenCV's bundled encoder (no system ffmpeg
    needed — opencv wheels ship their own). Frames are RGB uint8."""
    import cv2

    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                         fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed to open {path}")
    try:
        for f in frames:
            vw.write(f[..., ::-1])  # RGB -> BGR
    finally:
        vw.release()
    return path


def save_video(path: str, frames, fps: int = 30, log=print) -> str:
    """Best-available encode for an MP4 target, in order: imageio's
    ffmpeg plugin, OpenCV's bundled MPEG-4 encoder, MJPEG AVI (always
    works, zero deps). Returns the path written (extension may change
    from .mp4 to .avi only if every MP4 encoder is unavailable). The
    reference force-keeps .mp4 artifacts (the reference's .gitignore:
    31-40); the cv2 fallback makes that achievable without a system
    ffmpeg."""
    if path.endswith(".mp4"):
        try:
            import imageio

            imageio.mimsave(path, frames, fps=fps)
            return path
        except Exception:
            pass
        try:
            return _mp4_cv2(path, frames, fps)
        except Exception:
            path = path[:-4] + ".avi"
    elif not path.endswith(".avi"):
        path = path + ".avi"
    return write_mjpeg_avi(path, frames, fps=fps)
