"""The port's PNG codec (utils/images.read_png/write_png, zlib and struct
only) against imageio, both ways and bit for bit: 8-bit grey, grey+alpha,
RGB and RGBA, every row filter type, and what it refuses."""
import struct
import zlib

import numpy as np
import pytest

from efficient_nerf_tpu_torch.utils.images import read_png, save_image, to8b, write_png

imageio = pytest.importorskip("imageio.v2")

CHANNELS = [1, 2, 3, 4]


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filtered_png(path, img, filter_type):
    """A PNG of img [H, W, C] uint8 whose every row carries `filter_type`
    (PNG specification, section 9), to read back here and in imageio."""
    H, W = img.shape[:2]
    C = img.shape[2] if img.ndim == 3 else 1
    x = img.reshape(H, W * C).astype(np.int32)
    left = np.zeros_like(x)
    left[:, C:] = x[:, :-C]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, C:] = x[:-1, :-C]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    pred = [np.zeros_like(x), left, up, (left + up) // 2, paeth][filter_type]
    rows = ((x - pred) % 256).astype(np.uint8)
    raw = np.concatenate([np.full((H, 1), filter_type, np.uint8), rows], 1)
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))


def _image(rng, C, H=13, W=17):
    img = rng.integers(0, 256, (H, W, C)).astype(np.uint8)
    return img[..., 0] if C == 1 else img


@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("filter_type", range(5))
def test_every_filter_type_reads_as_in_imageio(C, filter_type, rng, tmp_path):
    img = _image(rng, C)
    path = str(tmp_path / "a.png")
    _filtered_png(path, img, filter_type)
    np.testing.assert_array_equal(imageio.imread(path), img)
    got = read_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("C", CHANNELS)
def test_written_png_reads_back_in_imageio_and_here(C, rng, tmp_path):
    img = _image(rng, C)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("C", CHANNELS)
def test_imageio_png_reads_here(C, rng, tmp_path):
    # random noise, and a smooth gradient whose rows imageio's encoder files
    # under the predicting filters (Sub, Up, Average, Paeth)
    y, x = np.mgrid[:40, :48]
    smooth = np.stack([(x + y) % 256, (3 * x) % 256, (5 * y) % 256, (x * y) % 256],
                      -1)[..., :C].astype(np.uint8)
    for img in (_image(rng, C), smooth[..., 0] if C == 1 else smooth):
        path = str(tmp_path / "b.png")
        imageio.imwrite(path, img)
        np.testing.assert_array_equal(read_png(path), img)


def _png(tmp_path, depth, colour, interlace=0, rows=b"\x00\x00"):
    ihdr = struct.pack(">IIBBBBB", 1, 1, depth, colour, 0, 0, interlace)
    path = tmp_path / "c.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                     + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b""))
    return str(path)


def test_unsupported_features_raise(tmp_path):
    with pytest.raises(ValueError, match="16-bit"):
        read_png(_png(tmp_path, 16, 0))
    with pytest.raises(ValueError, match="palette"):
        read_png(_png(tmp_path, 8, 3))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(_png(tmp_path, 8, 0, interlace=1))
    with pytest.raises(ValueError, match="filter type 7"):
        read_png(_png(tmp_path, 8, 0, rows=b"\x07\x00"))
    (tmp_path / "d.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(tmp_path / "d.png"))
    with pytest.raises(ValueError, match="8-bit"):
        write_png(str(tmp_path / "e.png"), np.zeros((2, 2), np.float32))


def test_save_image_writes_to8b(rng, tmp_path):
    img = rng.uniform(-0.2, 1.2, size=(6, 5, 3)).astype(np.float32)
    save_image(str(tmp_path / "f.png"), img)
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / "f.png")), to8b(img))
