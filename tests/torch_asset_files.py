"""Seeded scene files for the port's tests and chip_smoke.py: PNGs with
every row filter, a resource directory in the layout
`scene.assets.reference_assets_scene` reads, meshes as OBJ files and a
JSON scene spec. Numpy and fovtrace_torch only (chip_smoke.py imports
this module on the card's machine, which has no JAX)."""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

from fovtrace_torch.scene import image_io


def _pred(ft, a, b, c):
    """The PNG predictor of filter `ft` from the left, up and upper-left
    bytes (int arrays)."""
    if ft == 0:
        return np.zeros_like(a)
    if ft == 1:
        return a
    if ft == 2:
        return b
    if ft == 3:
        return (a + b) >> 1
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_bytes(rows: np.ndarray, w: int, bitdepth: int, color_type: int,
              bpp: int, filters=(0, 1, 2, 3, 4), palette=None) -> bytes:
    """A PNG of the decoded [h, stride] byte rows, row y filtered with
    filters[y % len(filters)]. An encoder predicts from the decoded
    bytes, which it has, so every filter is vectorised over the image;
    the IDAT stream is split over two chunks."""
    h, stride = rows.shape
    r = rows.astype(np.int64)
    up = np.vstack([np.zeros((1, stride), np.int64), r[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int64), r[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int64), up[:, :-bpp]])
    ft = np.asarray(filters)[np.arange(h) % len(filters)]
    enc = np.empty((h, 1 + stride), np.uint8)
    enc[:, 0] = ft
    for f in np.unique(ft):
        sel = ft == f
        enc[sel, 1:] = (r[sel] - _pred(f, left[sel], up[sel], upleft[sel])) \
            & 0xFF

    def chunk(ctype, payload):
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, bitdepth, color_type, 0, 0, 0)
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
    if palette is not None:
        data += chunk(b"PLTE", palette.tobytes())
    z = zlib.compress(enc.tobytes(), 6)
    return (data + chunk(b"IDAT", z[:len(z) // 2])
            + chunk(b"IDAT", z[len(z) // 2:]) + chunk(b"IEND", b""))


def texture(rng, h: int, w: int) -> np.ndarray:
    """A seeded [h, w, 3] uint8 albedo: blocks of colour, a gradient and
    noise, so every PNG predictor sees smooth and rough rows."""
    yy, xx = np.mgrid[0:h, 0:w]
    block = rng.integers(40, 220, ((h + 15) // 16, (w + 15) // 16, 3))
    img = block[yy // 16, xx // 16] + (xx * 60 // max(w, 1))[..., None]
    img = img + rng.integers(-12, 13, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def envmap(rng, h: int, w: int) -> np.ndarray:
    """A seeded lat-long HDR sky: a gradient, a sun up to ~45 and noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    sky = (1.0 - yy / h)[..., None] * np.float32([0.35, 0.55, 1.0]) + 0.1
    sun = np.exp(-((yy - 0.25 * h) ** 2 + (xx - 0.3 * w) ** 2)
                 / (0.0004 * h * w))[..., None] * np.float32([45, 40, 32])
    noise = rng.uniform(0.0, 0.05, (h, w, 3))
    return (sky + sun + noise).astype(np.float32)


def write_png(path, img_u8: np.ndarray) -> None:
    h, w = img_u8.shape[:2]
    with open(path, "wb") as f:
        f.write(png_bytes(img_u8.reshape(h, w * 3), w, 8, 2, 3))


def write_resource_dir(root, seed: int = 7, hdr=(16, 32), png=24, grid=8,
                       bunny=6) -> dict:
    """A resource directory as reference_assets_scene reads it:
    CedarCity.hdr (RLE scanlines, `hdr` = (height, width)), grid.ppm,
    vokselia_spawn/vokselia_spawn.{png,mtl} (the PNG's rows in all five
    filters; a 'Stone' Kd) and bunny/bunny.{PPM,mtl}. Returns the sizes."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "vokselia_spawn"), exist_ok=True)
    os.makedirs(os.path.join(root, "bunny"), exist_ok=True)
    image_io.save_hdr(os.path.join(root, "CedarCity.hdr"), envmap(rng, *hdr))
    image_io.save_ppm(os.path.join(root, "grid.ppm"), texture(rng, grid, grid))
    write_png(os.path.join(root, "vokselia_spawn", "vokselia_spawn.png"),
              texture(rng, png, png))
    with open(os.path.join(root, "vokselia_spawn", "vokselia_spawn.mtl"),
              "w") as f:
        f.write("newmtl Grass\nKd 0.3 0.6 0.2\n"
                "newmtl Stone\nKd 0.52 0.5 0.47\nmap_Kd vokselia_spawn.png\n")
    image_io.save_ppm(os.path.join(root, "bunny", "bunny.PPM"),
                      texture(rng, bunny, bunny))
    with open(os.path.join(root, "bunny", "bunny.mtl"), "w") as f:
        f.write("newmtl bunny\nKd 0.8 0.75 0.7\nmap_Kd bunny.PPM\n")
    return {"hdr": tuple(hdr), "png": png, "grid": grid, "bunny": bunny}


def write_obj(path, vertices, triangles, normals=None, uvs=None,
              groups=None, mtllib=None) -> None:
    """A mesh as an OBJ file: v (and vt, vn, one per vertex) lines, then
    the faces, each corner `i/i/i` with what the mesh has; `groups` =
    [(material name, first triangle), ...] puts usemtl lines before
    those triangles."""
    def lines(tag, a):
        a = np.asarray(a, np.float32)
        row = tag + " %.9g" * a.shape[1] + "\n"
        return (row * a.shape[0]) % tuple(a.reshape(-1).tolist())

    out = [f"mtllib {mtllib}\n"] if mtllib else []
    out.append(lines("v", vertices))
    corner = "%d"
    if uvs is not None:
        out.append(lines("vt", uvs))
        corner += "/%d"
    if normals is not None:
        out.append(lines("vn", normals))
        corner += "/%d" if uvs is not None else "//%d"
    per = corner.count("%d")
    ids = np.repeat(np.asarray(triangles, np.int64) + 1, per, axis=1)
    face = "f " + " ".join([corner] * 3) + "\n"
    cuts = [(0, None)] + [(first, name) for name, first in (groups or [])]
    cuts.sort(key=lambda c: c[0])
    ends = [c[0] for c in cuts[1:]] + [len(ids)]
    for (start, name), end in zip(cuts, ends):
        if name is not None:
            out.append(f"usemtl {name}\n")
        out.append((face * (end - start))
                   % tuple(ids[start:end].reshape(-1).tolist()))
    with open(path, "w") as f:
        f.write("".join(out))


def write_mesh_scene(root, meshes, name: str, textured: bool,
                     tex_size: int = 16, seed: int = 3) -> str:
    """Procedural mesh dicts (`scene.procedural._mesh`) as one OBJ file
    `name`.obj in root: geometry only, or (textured) with vt / vn, one
    usemtl group per mesh and an MTL whose first material maps a PNG.
    Returns the OBJ's path."""
    from fovtrace_torch.scene.scene import merge_meshes

    v, t, _, n, uv = merge_meshes(meshes)
    path = os.path.join(root, f"{name}.obj")
    if not textured:
        write_obj(path, v, t)
        return path
    rng = np.random.default_rng(seed)
    write_png(os.path.join(root, f"{name}.png"),
              texture(rng, tex_size, tex_size))
    names = [f"part{k}" for k in range(len(meshes))]
    with open(os.path.join(root, f"{name}.mtl"), "w") as f:
        f.write(f"newmtl {names[0]}\nKd 1 1 1\nmap_Kd {name}.png\n")
        for k, nm in enumerate(names[1:], 1):
            f.write(f"newmtl {nm}\nKd {0.3 + 0.15 * k:.2f} 0.6 "
                    f"{0.8 - 0.1 * k:.2f}\n")
    first = np.cumsum([0] + [len(m["triangles"]) for m in meshes[:-1]])
    write_obj(path, v, t, normals=n, uvs=uv,
              groups=list(zip(names, first.tolist())), mtllib=f"{name}.mtl")
    return path


def write_spec(root, model: str, second: str, envmap_file: str,
               name: str = "spec") -> str:
    """A JSON scene spec: `model` scaled and moved, `second` in refraction
    beside it, the envmap `envmap_file` and a dimmer light."""
    spec = {"models": [
        {"path": os.path.relpath(model, root), "material": "diffuse",
         "scale": 0.5, "translate": [0.25, 0.0, -0.5]},
        {"path": os.path.relpath(second, root), "material": "refraction",
         "scale": 1.5, "translate": [0.0, 0.6, 1.0], "kd": [0.9, 0.95, 1.0]}],
        "light_power": 600.0, "envmap": os.path.relpath(envmap_file, root)}
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path
