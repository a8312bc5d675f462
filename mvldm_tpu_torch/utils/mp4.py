"""Minimal pure-Python MP4 (ISO BMFF) muxer for Motion-JPEG video
(counterpart of ``mvldm_tpu/utils/mp4.py``).

The reference exports 25/10-fps MP4s via moviepy+ffmpeg
(``src/model/diffusion_wrapper.py:1073-1088``); :func:`write_mjpeg_mp4`
writes the container directly, with no encoder library: JPEG
frames become the samples of an ISO media file with an ``mp4v`` visual
sample entry whose ESDS declares objectTypeIndication 0x6C (JPEG) — the
same layout ffmpeg produces for ``-c:v mjpeg`` in MP4, playable by
ffmpeg/VLC/QuickTime.

Box layout: ftyp | mdat(all JPEGs) | moov(mvhd, trak(tkhd, mdia(mdhd, hdlr,
minf(vmhd, dinf, stbl(stsd(mp4v+esds), stts, stsc, stsz, stco))))).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Sequence, Tuple, Union


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def _full_box(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(kind, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)


def _descriptor(tag: int, payload: bytes) -> bytes:
    """MPEG-4 descriptor with the canonical 4-byte expandable length."""
    n = len(payload)
    size = bytes(
        [0x80 | ((n >> (7 * i)) & 0x7F) for i in range(3, 0, -1)] + [n & 0x7F]
    )
    return bytes([tag]) + size + payload


def _esds() -> bytes:
    """ES descriptor declaring a JPEG (OTI 0x6C) visual stream."""
    dec_config = _descriptor(
        0x04,
        struct.pack(
            ">BBBHII",
            0x6C,        # objectTypeIndication: JPEG
            (4 << 2) | 1,  # streamType=visual(4), upStream=0, reserved=1
            0, 0,        # bufferSizeDB (3 bytes, split as B + H)
            0,           # maxBitrate
            0,           # avgBitrate
        ),
    )
    sl_config = _descriptor(0x06, b"\x02")
    es = _descriptor(0x03, struct.pack(">HB", 1, 0) + dec_config + sl_config)
    return _full_box(b"esds", 0, 0, es)


def _stsd(width: int, height: int) -> bytes:
    entry = (
        b"\x00" * 6                      # reserved
        + struct.pack(">H", 1)           # data_reference_index
        + b"\x00" * 16                   # pre_defined / reserved
        + struct.pack(">HH", width, height)
        + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
        + struct.pack(">I", 0)           # reserved
        + struct.pack(">H", 1)           # frame_count
        + b"\x00" * 32                   # compressorname
        + struct.pack(">Hh", 0x0018, -1)  # depth, pre_defined
        + _esds()
    )
    return _full_box(b"stsd", 0, 0, struct.pack(">I", 1) + _box(b"mp4v", entry))


def _matrix() -> bytes:
    return struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def write_mjpeg_mp4(
    jpeg_frames: Sequence[bytes],
    path: Union[Path, str],
    fps: int,
    size: Tuple[int, int],
) -> None:
    """Write JPEG-encoded frames as an MJPEG .mp4. ``size`` is (width, height)."""
    width, height = size
    n = len(jpeg_frames)
    if n == 0:
        raise ValueError("no frames")
    timescale = 1000
    sample_delta = timescale // fps
    duration = sample_delta * n

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")
    mdat_payload = b"".join(jpeg_frames)
    # First sample offset: ftyp + mdat header (8 bytes).
    first_sample_offset = len(ftyp) + 8

    mvhd = _full_box(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, timescale, duration)
        + struct.pack(">IH", 0x00010000, 0x0100)  # rate, volume
        + b"\x00" * 10
        + _matrix()
        + b"\x00" * 24
        + struct.pack(">I", 2),  # next_track_ID
    )
    tkhd = _full_box(
        b"tkhd", 0, 0x7,  # enabled | in_movie | in_preview
        struct.pack(">IIIII", 0, 0, 1, 0, duration)
        + b"\x00" * 8
        + struct.pack(">HHHH", 0, 0, 0, 0)  # layer, group, volume, reserved
        + _matrix()
        + struct.pack(">II", width << 16, height << 16),
    )
    mdhd = _full_box(
        b"mdhd", 0, 0,
        struct.pack(">IIII", 0, 0, timescale, duration)
        + struct.pack(">HH", 0x55C4, 0),  # language 'und'
    )
    hdlr = _full_box(
        b"hdlr", 0, 0,
        struct.pack(">I", 0) + b"vide" + b"\x00" * 12 + b"VideoHandler\x00",
    )
    vmhd = _full_box(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    dinf = _box(
        b"dinf",
        _full_box(b"dref", 0, 0, struct.pack(">I", 1) + _full_box(b"url ", 0, 1, b"")),
    )
    stts = _full_box(
        b"stts", 0, 0, struct.pack(">III", 1, n, sample_delta)
    )
    stsc = _full_box(
        b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)
    )
    stsz = _full_box(
        b"stsz", 0, 0,
        struct.pack(">II", 0, n)
        + b"".join(struct.pack(">I", len(f)) for f in jpeg_frames),
    )
    stco = _full_box(
        b"stco", 0, 0, struct.pack(">II", 1, first_sample_offset)
    )
    stbl = _box(b"stbl", _stsd(width, height) + stts + stsc + stsz + stco)
    minf = _box(b"minf", vmhd + dinf + stbl)
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    trak = _box(b"trak", tkhd + mdia)
    moov = _box(b"moov", mvhd + trak)

    path = Path(path)
    path.parent.mkdir(exist_ok=True, parents=True)
    with open(path, "wb") as f:
        f.write(ftyp)
        f.write(_box(b"mdat", mdat_payload))
        f.write(moov)


def parse_boxes(data: bytes) -> List[Tuple[bytes, bytes]]:
    """Top-level (or container-payload) box parse — used by tests and sanity
    checks; returns [(kind, payload), ...]."""
    out = []
    pos = 0
    while pos + 8 <= len(data):
        size, kind = struct.unpack(">I4s", data[pos : pos + 8])
        if size < 8 or pos + size > len(data):
            raise ValueError(f"bad box {kind!r} size {size} at {pos}")
        out.append((kind, data[pos + 8 : pos + size]))
        pos += size
    if pos != len(data):
        raise ValueError("trailing bytes after last box")
    return out
