"""The port's codecs, OBJ / MTL parsers and BVH builders against the JAX
package's (`fovtrace.scene.image_io`, `fovtrace.scene.obj`,
`fovtrace.scene.bvh`) on the same bytes: arrays bit for bit."""

import struct

import numpy as np
import pytest
import torch

from fovtrace.scene import bvh as jbvh
from fovtrace.scene import image_io as jio
from fovtrace.scene import obj as jobj
from fovtrace_torch import native
from fovtrace_torch.scene import bvh as tbvh
from fovtrace_torch.scene import image_io as tio
from fovtrace_torch.scene import obj as tobj
from torch_asset_files import png_bytes


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once (see
    # tests/test_torch_frame.py)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- PNG
PNG_KINDS = [(ct, bd) for ct in (0, 4, 2, 6) for bd in (8, 16)] + [(3, 8)]


@pytest.mark.parametrize("color_type,bitdepth", PNG_KINDS)
def test_load_png_every_kind_and_filter(tmp_path, color_type, bitdepth):
    rng = np.random.default_rng(10 * color_type + bitdepth)
    h, w = 11, 9
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    bpp = channels * bitdepth // 8
    palette = None
    if color_type == 3:
        palette = rng.integers(0, 256, (7, 3), dtype=np.uint8)
        rows = rng.integers(0, 7, (h, w), dtype=np.uint8)
    else:
        # smooth content plus noise, so every predictor has work to do
        ramp = (np.arange(w * bpp)[None] * 5 + np.arange(h)[:, None] * 9)
        rows = ((ramp + rng.integers(0, 40, (h, w * bpp))) % 256).astype(
            np.uint8)
    p = tmp_path / "x.png"
    p.write_bytes(png_bytes(rows, w, bitdepth, color_type, bpp,
                            [0, 1, 2, 3, 4], palette))
    got, want = tio.load_png(str(p)), jio.load_png(str(p))
    assert got.dtype == want.dtype == np.float32 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


def test_png_writer_and_bad_filter(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (6, 5, 3), np.uint8)
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    tio.save_png(str(a), img)
    jio.save_png(str(b), img)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(tio.load_png(str(a)), img / np.float32(255))
    bad = tmp_path / "bad.png"
    bad.write_bytes(png_bytes(img.reshape(6, 15), 5, 8, 2, 3, [0, 7]))
    with pytest.raises(ValueError, match="bad PNG filter 7"):
        tio.load_png(str(bad))
    with pytest.raises(ValueError):
        jio.load_png(str(bad))


# ------------------------------------------------------------ PPM, BMP
def test_ppm_p6_p3_and_16_bit(tmp_path):
    img = np.random.default_rng(0).uniform(size=(7, 9, 3)).astype(np.float32)
    a, b = tmp_path / "a.ppm", tmp_path / "b.ppm"
    tio.save_ppm(str(a), img)
    jio.save_ppm(str(b), img)
    assert a.read_bytes() == b.read_bytes()
    p3 = tmp_path / "p3.ppm"
    p3.write_text("P3\n# a comment\n3 2\n# another\n255\n"
                  "255 0 0  0 255 0  0 0 255\n1 2 3  4 5 6  7 8 9\n")
    p16 = tmp_path / "p16.ppm"
    vals = np.random.default_rng(1).integers(0, 65536, (4, 5, 3))
    p16.write_bytes(b"P6\n5 4\n65535\n" + vals.astype(">u2").tobytes())
    for p in (a, p3, p16):
        got, want = tio.load_ppm(str(p)), jio.load_ppm(str(p))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w", [5, 8, 13])
def test_bmp_bytes_and_rows(tmp_path, w):
    """Widths whose rows need 1, 0 and 1 padding bytes; floats and uint8."""
    rng = np.random.default_rng(w)
    for img in (rng.uniform(size=(6, w, 3)).astype(np.float32),
                rng.integers(0, 256, (6, w, 3), np.uint8)):
        a, b = tmp_path / "a.bmp", tmp_path / "b.bmp"
        tio.save_bmp(str(a), img)
        jio.save_bmp(str(b), img)
        assert a.read_bytes() == b.read_bytes()
        np.testing.assert_array_equal(tio.load_bmp(str(a)),
                                      jio.load_bmp(str(a)))
    # a top-down file (negative height)
    data = bytearray(a.read_bytes())
    data[22:26] = struct.pack("<i", -6)
    a.write_bytes(bytes(data))
    np.testing.assert_array_equal(tio.load_bmp(str(a)), jio.load_bmp(str(a)))


# ------------------------------------------------------------------- HDR
def test_hdr_flat_and_rle(tmp_path):
    rng = np.random.default_rng(4)
    # flat scanlines, by hand (as tests/test_io.py writes them)
    rgbe = rng.integers(0, 256, (3, 5, 4), np.uint8)
    rgbe[:, 0, :2] = 7          # no scanline starts 2, 2
    rgbe[1, 2, 3] = 0           # a zero exponent
    flat = tmp_path / "flat.hdr"
    flat.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 3 +X 5\n"
                     + rgbe.tobytes())
    # RLE scanlines, runs and literals: smooth rows and noisy ones
    yy, xx = np.mgrid[0:12, 0:300]
    img = (np.exp(-((yy - 3) ** 2 + (xx - 80) ** 2) / 500.0)[..., None] * 40
           + np.float32([0.25, 0.5, 1.0])).astype(np.float32)
    img[5:7] += rng.uniform(0, 2, (2, 300, 3)).astype(np.float32)
    img[9, 100:180] = 0.0
    rle = tmp_path / "rle.hdr"
    tio.save_hdr(str(rle), img)
    raw = rle.read_bytes()
    body = raw[raw.index(b"+X 300\n") + 7:]
    assert body[:4] == bytes((2, 2, 1, 44))
    for p in (flat, rle):
        got, want = tio.load_hdr(str(p)), jio.load_hdr(str(p))
        np.testing.assert_array_equal(got, want)
    # RGBE keeps 8 bits of mantissa
    got = tio.load_hdr(str(rle))
    assert np.all(np.abs(got - img) <= img.max(-1, keepdims=True) / 128)


# ------------------------------------------------------------ OBJ / MTL
OBJS = {
    "quads_negative": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 2 2 0\n"
                      "f -5 -4 -3 -2\nf 1 2 5\n",
    "dedup": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
             "vt 0 0\nvt 1 0\nvt 1 1\nvn 0 0 1\nvn 0 0 -1\n"
             "f 1/1/1 2/2/1 3/3/1\nf 1/1/1 3/3/2 4/1/1\nf 4//2 3//2 2//2\n"
             "f 2/2 3/3 4/1\n",
    "usemtl": "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0 0\n"
              "vt 1 1\nf 1 2 3\nusemtl red\nf 1/1 2/2 3/1\nusemtl tex\n"
              "f 2 4 3\nusemtl red\nf 4 3 1\nusemtl nothere\nf 1 2 4\n",
    "missing_mtl": "mtllib gone.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                   "usemtl a\nf 1 2 3\n",
}
MTL = ("# materials\nnewmtl red\nKd 1 0 0\nKs 0.5 0.5 0.5\nNs 10\nd 0.5\n"
       "newmtl tex\nKd 0.2 0.4 0.6\nmap_Kd -bm 1 tex.ppm\n")


def _same_obj(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got[:5], want[:5]):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert got[5] == want[5]


@pytest.mark.parametrize("name", sorted(OBJS))
def test_load_obj_matches_reference(tmp_path, name):
    (tmp_path / "m.mtl").write_text(MTL)
    p = tmp_path / f"{name}.obj"
    p.write_text(OBJS[name])
    _same_obj(tobj.load_obj(str(p)), jobj.load_obj(str(p)))
    _same_obj(tobj._load_obj_py(str(p)), jobj._load_obj_py(str(p)))
    assert tobj.load_mtl(str(tmp_path / "m.mtl")) == \
        jobj.load_mtl(str(tmp_path / "m.mtl"))
    assert tobj.load_mtl(str(tmp_path / "gone.mtl")) == {}


def test_obj_native_matches_python(tmp_path):
    """The native parser (files without usemtl) against the Python one."""
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\nvt 0 0\n"
                 "vt 1 0\nvt 1 1\nf 1/1/1 2/2/1 3/3/1\nf 1/1/1 3/3/1 4/1/1\n")
    pos, tris, norm, uv = native.load_obj_native(str(p))
    pv, pt, pn, puv, fm, mats = tobj._load_obj_py(str(p))
    np.testing.assert_array_equal(pos, pv)
    np.testing.assert_array_equal(tris, pt)
    np.testing.assert_array_equal(norm, pn)
    np.testing.assert_array_equal(uv, puv)
    # negative indices and a quad: the same two triangles
    q = tmp_path / "neg.obj"
    q.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf -4 -3 -2 -1\n")
    np.testing.assert_array_equal(native.load_obj_native(str(q))[1],
                                  tobj._load_obj_py(str(q))[1])
    # nothing to parse: the Python parser says why
    assert native.load_obj_native(str(tmp_path / "none.obj")) is None


# ------------------------------------------------------------------- BVH
def _random_tris(n, seed):
    rng = np.random.default_rng(seed)
    v0 = (rng.normal(size=(n, 3)) * 5).astype(np.float32)
    e1 = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    e2 = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    valid = np.ones(n, bool)
    valid[::7] = False
    # a cluster of coincident triangles: a leaf over max_leaf
    v0[1:40:2] = v0[1]
    return v0, e1, e2, valid


def _same_bvh(a, b):
    for k in ("nodes_min", "nodes_max", "nodes_left", "nodes_right",
              "nodes_leaf", "order"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.max_depth == b.max_depth


@pytest.mark.parametrize("n,seed", [(600, 0), (2000, 1)])
def test_bvh_builders_match(n, seed):
    """The port's builder against both of the reference's, native and
    Python (the tree tests/test_native.py holds them to)."""
    tris = _random_tris(n, seed)
    native_bvh = tbvh.build_bvh(*tris)
    _same_bvh(native_bvh, jbvh.build_bvh(*tris, use_native=True))
    _same_bvh(native_bvh, jbvh.build_bvh(*tris, use_native=False))
    covered = native_bvh.order[native_bvh.order >= 0]
    assert sorted(covered) == np.flatnonzero(tris[3]).tolist()
