"""Images without PIL: a PNG reader and writer on the standard library
(`zlib`, the five row filters) and Pillow's 8-bit bicubic resize in numpy.

The machine with the card has no PIL, and CelebA's image folder goes
through both steps: `data._load_image_folder` decodes each file
with `read_png` (PIL only for other formats, where it is installed) and
resizes it with `resize_bicubic`, which gives Pillow's
`Image.resize(..., Image.BICUBIC)` on uint8 images bit for bit: the same
filter support, the same float64 coefficients, the same 22-bit fixed-point
weights and the same rounding, one horizontal pass, then one vertical pass
(`libImaging/Resample.c`: `precompute_coeffs`, `normalize_coeffs_8bpc`,
`ImagingResampleHorizontal_8bpc`, `ImagingResampleVertical_8bpc`).

`write_png` writes 8-bit grayscale, RGB, palette, grayscale+alpha and RGBA
files with every row filter, so that seeded folders can be made on a
machine without PIL and every decoding path is exercised.
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel (8-bit): gray, RGB, palette, gray+alpha,
# RGBA
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class UnsupportedPNG(ValueError):
  """A PNG that `read_png` does not decode (interlaced, or not 8 bits a
  sample); PIL reads it where it is installed."""


def _chunks(data: bytes):
  pos = len(PNG_SIGNATURE)
  while pos + 8 <= len(data):
    length, kind = struct.unpack(">I4s", data[pos:pos + 8])
    yield kind, data[pos + 8:pos + 8 + length]
    pos += 12 + length
    if kind == b"IEND":
      return


def _paeth(a: int, b: int, c: int) -> int:
  p = a + b - c
  pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
  if pa <= pb and pa <= pc:
    return a
  return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
  """The [height, stride] bytes of the image from its filtered scanlines
  (one filter byte, then `stride` bytes, each row)."""
  out = np.zeros((height, stride), np.uint8)
  prior = np.zeros(stride, np.uint8)
  for y in range(height):
    start = y * (stride + 1)
    ftype = raw[start]
    line = np.frombuffer(raw, np.uint8, stride, start + 1)
    if ftype == 0:
      row = line.copy()
    elif ftype == 1:  # Sub: the byte bpp to the left, summed along the row
      row = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64)
             % 256).astype(np.uint8).reshape(-1)
    elif ftype == 2:  # Up
      row = line + prior
    elif ftype in (3, 4):  # Average, Paeth: byte by byte
      cur = bytearray(line.tobytes())
      up = prior.tobytes()
      for i in range(stride):
        left = cur[i - bpp] if i >= bpp else 0
        if ftype == 3:
          pred = (left + up[i]) >> 1
        else:
          pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
        cur[i] = (cur[i] + pred) & 0xFF
      row = np.frombuffer(bytes(cur), np.uint8)
    else:
      raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
    out[y] = row
    prior = out[y]
  return out


def read_png(path: str) -> np.ndarray:
  """An 8-bit, non-interlaced PNG as uint8 [H, W, 3], what PIL's
  `Image.open(path).convert("RGB")` gives: gray replicated, alpha
  dropped, palette indices looked up. Raises UnsupportedPNG for other
  PNGs."""
  with open(path, "rb") as f:
    data = f.read()
  if not data.startswith(PNG_SIGNATURE):
    raise ValueError(f"{path} is not a PNG file")
  header, palette, idat = None, None, []
  for kind, body in _chunks(data):
    if kind == b"IHDR":
      header = struct.unpack(">IIBBBBB", body)
    elif kind == b"PLTE":
      palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    elif kind == b"IDAT":
      idat.append(body)
  if header is None:
    raise ValueError(f"{path}: no IHDR chunk")
  width, height, depth, ctype, _, _, interlace = header
  if depth != 8 or interlace or ctype not in _SAMPLES:
    raise UnsupportedPNG(f"{path}: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}; the reader takes 8-bit "
                         "non-interlaced images")
  n = _SAMPLES[ctype]
  pix = _unfilter(zlib.decompress(b"".join(idat)), height, width * n,
                  n).reshape(height, width, n)
  if ctype == 3:
    if palette is None:
      raise ValueError(f"{path}: a palette image without PLTE")
    return palette[pix[..., 0]]
  if ctype in (0, 4):
    return np.repeat(pix[..., :1], 3, axis=2)
  return np.ascontiguousarray(pix[..., :3])


def _filter_row(ftype: int, row: np.ndarray, prior: np.ndarray,
                bpp: int) -> bytes:
  """One scanline filtered with `ftype` (the inverse of `_unfilter`)."""
  r = row.astype(np.int64)
  p = prior.astype(np.int64)
  left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
  upleft = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])
  if ftype == 0:
    pred = np.zeros_like(r)
  elif ftype == 1:
    pred = left
  elif ftype == 2:
    pred = p
  elif ftype == 3:
    pred = (left + p) >> 1
  else:
    pa, pb, pc = (np.abs(p - upleft), np.abs(left - upleft),
                  np.abs(left + p - 2 * upleft))
    pred = np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, p, upleft))
  return bytes([ftype]) + ((r - pred) % 256).astype(np.uint8).tobytes()


def write_png(path: str, img: np.ndarray, color_type: int = 2,
              palette: np.ndarray = None):
  """Write uint8 `img` as an 8-bit PNG of `color_type`: [H, W] or
  [H, W, 1] for gray (0) and palette indices (3, with `palette` [N, 3]),
  [H, W, 2] gray+alpha (4), [H, W, 3] RGB (2), [H, W, 4] RGBA (6). Row y
  takes filter y % 5, so a file holds all five."""
  img = np.asarray(img, np.uint8)
  if img.ndim == 2:
    img = img[..., None]
  n = _SAMPLES[color_type]
  if img.shape[2] != n:
    raise ValueError(f"colour type {color_type} takes {n} samples a pixel, "
                     f"got {img.shape[2]}")
  height, width = img.shape[:2]
  rows = img.reshape(height, width * n)
  prior = np.zeros(width * n, np.uint8)
  raw = bytearray()
  for y in range(height):
    raw += _filter_row(y % 5, rows[y], prior, n)
    prior = rows[y]

  def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

  out = PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
      ">IIBBBBB", width, height, 8, color_type, 0, 0, 0))
  if color_type == 3:
    out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
  out += chunk(b"IDAT", zlib.compress(bytes(raw), 6)) + chunk(b"IEND", b"")
  with open(path, "wb") as f:
    f.write(out)


# ---- Pillow's 8-bit bicubic resample ----

_PRECISION_BITS = 32 - 8 - 2
_SUPPORT = 2.0  # the bicubic filter's support


def _bicubic(x: float) -> float:
  """Pillow's `bicubic_filter` (a = -0.5), its float64 operations in their
  order."""
  a = -0.5
  if x < 0.0:
    x = -x
  if x < 1.0:
    return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
  if x < 2.0:
    return (((x - 5) * x + 8) * x - 4) * a
  return 0.0


@functools.lru_cache(maxsize=64)
def pil_bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
  """[out_size, in_size] float64: Pillow's bicubic taps of each output of
  one axis over the box (0, in_size) (`precompute_coeffs`: support 2
  widened by the scale when shrinking, each output's window rounded and
  clipped to the input, its taps summed in order and divided by the sum),
  zero outside each window. Cached, read-only; the float modes' resize
  (`evaluation.clean_resize`) and the 8-bit one's (`_weights`) take it."""
  scale = float(in_size) / out_size
  filterscale = max(scale, 1.0)
  support = _SUPPORT * filterscale
  ss = 1.0 / filterscale
  out = np.zeros((out_size, in_size))
  for xx in range(out_size):
    center = (xx + 0.5) * scale
    xmin = max(int(center - support + 0.5), 0)
    xmax = min(int(center + support + 0.5), in_size) - xmin
    k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
    ww = 0.0
    for w in k:
      ww += w
    out[xx, xmin:xmin + xmax] = [w / ww for w in k] if ww != 0.0 else k
  out.flags.writeable = False
  return out


@functools.lru_cache(maxsize=64)
def _weights(in_size: int, out_size: int) -> np.ndarray:
  """[out_size, in_size] int64: the taps in Pillow's 22-bit fixed point
  (`normalize_coeffs_8bpc`: rounded half away from zero)."""
  w = pil_bicubic_weights(in_size, out_size) * (1 << _PRECISION_BITS)
  return np.trunc(w + np.where(w < 0, -0.5, 0.5)).astype(np.int64)


def _pass(img: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
  """One fixed-point pass along `axis` (0 rows, 1 columns) of uint8
  [H, W, C]: the sum of the taps from half a unit, shifted down and
  clipped to [0, 255] (Pillow's `clip8`)."""
  x = np.moveaxis(img.astype(np.int64), axis, 0)
  s = np.tensordot(weights, x, axes=(1, 0)) + (1 << (_PRECISION_BITS - 1))
  s = np.clip(s >> _PRECISION_BITS, 0, 255).astype(np.uint8)
  return np.ascontiguousarray(np.moveaxis(s, 0, axis))


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
  """uint8 [H, W, C] -> [height, width, C], as Pillow's
  `Image.fromarray(img).resize((width, height), Image.BICUBIC)`: the
  horizontal pass where the width changes, then the vertical one where
  the height changes, each rounded to uint8."""
  img = np.asarray(img, np.uint8)
  squeeze = img.ndim == 2
  if squeeze:
    img = img[..., None]
  if width != img.shape[1]:
    img = _pass(img, _weights(img.shape[1], width), 1)
  if height != img.shape[0]:
    img = _pass(img, _weights(img.shape[0], height), 0)
  return img[..., 0] if squeeze else img

