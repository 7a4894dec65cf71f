"""Image output + quality metrics (counterpart of ``rlrpt_tpu/utils/image.py``).

`tonemap` is the reference's 8-bit clamp (sdl_screen.cpp:96-108),
`write_bmp` its 24-bit BGR bottom-up dump, plus a dependency-free PNG
writer/reader and `mape_score` (ref: Graphing/mape.py:10-21).  Host-side
numpy; torch tensors are accepted and copied to the host.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _host(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def tonemap(img) -> np.ndarray:
    """HDR float image -> uint8, scale 255 + clamp."""
    img = np.asarray(_host(img), np.float32)
    return np.clip(img * 255.0, 0.0, 255.0).astype(np.uint8)


def write_bmp(path: str, img) -> None:
    """Write a 24-bit uncompressed BMP (the SDL_SaveImage output format)."""
    img_u8 = _host(img)
    if img_u8.dtype != np.uint8:
        img_u8 = tonemap(img_u8)
    h, w, _ = img_u8.shape
    row = w * 3
    stride = row + (-row) % 4
    header = struct.pack("<2sIHHI", b"BM", 54 + stride * h, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, stride * h,
                       2835, 2835, 0, 0)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :row] = img_u8[::-1, :, ::-1].reshape(h, row)  # bottom-up, BGR
    with open(path, "wb") as f:
        f.write(header)
        f.write(info)
        f.write(rows.tobytes())


def write_png(path: str, img) -> None:
    """Minimal dependency-free PNG (8-bit RGB) writer."""
    img_u8 = _host(img)
    if img_u8.dtype != np.uint8:
        img_u8 = tonemap(img_u8)
    h, w, _ = img_u8.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img_u8[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for 8-bit RGB files (filters 0-4 per row)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        ln = struct.unpack_from(">I", data, pos)[0]
        tag = data[pos + 4: pos + 8]
        payload = data[pos + 8: pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack_from(">IIBB", payload)
            if depth != 8 or ctype != 2:
                raise ValueError(f"{path}: only 8-bit RGB PNG is supported")
        elif tag == b"IDAT":
            idat += payload
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    p = 0
    for y in range(h):
        ft = raw[p]
        row = np.frombuffer(raw, np.uint8, count=stride,
                            offset=p + 1).astype(np.int32)
        p += 1 + stride
        if ft == 0:
            cur = row
        elif ft == 2:  # up
            cur = (row + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - 3] if i >= 3 else 0
                b = prev[i]
                c = prev[i - 3] if i >= 3 else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) // 2
                elif ft == 4:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                else:
                    raise ValueError(f"{path}: PNG filter {ft}")
                cur[i] = (row[i] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, 3)


def read_bmp(path: str) -> np.ndarray:
    """Read a 24-bit uncompressed BMP -> uint8 (H, W, 3) RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    offset = struct.unpack_from("<I", data, 10)[0]
    w = struct.unpack_from("<i", data, 18)[0]
    h = struct.unpack_from("<i", data, 22)[0]
    bpp = struct.unpack_from("<H", data, 28)[0]
    if bpp != 24:
        raise ValueError(f"{path}: only 24-bit BMP is supported, got {bpp}")
    flip = h > 0
    h = abs(h)
    stride = (w * 3 + 3) & ~3
    arr = np.frombuffer(data, np.uint8, count=stride * h, offset=offset)
    rgb = arr.reshape(h, stride)[:, : w * 3].reshape(h, w, 3)[:, :, ::-1]
    return rgb[::-1] if flip else rgb


def read_image(path: str) -> np.ndarray:
    if path.lower().endswith(".bmp"):
        return read_bmp(path)
    return read_png(path)


def mape_score(ground_truth, prediction) -> float:
    """Mean-absolute-percentage-error image metric:

        score = sum(|gt/255 - p/255| / ((gt + 0.01)/255)) / (W*H*3)
    """
    gt = np.asarray(_host(ground_truth), np.float64)
    p = np.asarray(_host(prediction), np.float64)
    score = np.sum(np.abs(gt / 255.0 - p / 255.0) / ((gt + 0.01) / 255.0))
    score /= gt.shape[0] * gt.shape[1] * gt.shape[2]
    return round(float(score), 4)
