"""Host time of decoding a filtered PNG: the reference's load_png against
the port's. Not a test (the reference takes seconds at 2048^2).

    PYTHONPATH=. python tests/torch_png_decode_time.py [SIDE]

Writes a SIDE x SIDE RGB PNG (default 2048, the reference's own
vokselia_spawn.png size) whose rows cycle through the five PNG filters,
decodes it with `fovtrace/scene/image_io.py`'s load_png and
`fovtrace_torch.scene.image_io.load_png`, checks the two arrays are
equal and prints both times and the host's CPU model. The reference's
module needs only numpy: it is loaded from its file, without the
`fovtrace` package (and so without JAX), so the script also runs on a
machine that has PyTorch and no JAX."""

import importlib.util
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fovtrace_torch import _build  # noqa: E402
from fovtrace_torch.scene import image_io as tio  # noqa: E402
from torch_asset_files import texture, write_png  # noqa: E402


def reference_image_io():
    path = os.path.join(HERE, "..", "fovtrace", "scene", "image_io.py")
    spec = importlib.util.spec_from_file_location("reference_image_io", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    side = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    jio = reference_image_io()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.png")
        write_png(path, texture(np.random.default_rng(7), side, side))
        tio.load_png(path)      # builds the unfilter library once
        times, imgs = {}, {}
        for name, fn in (("port", tio.load_png), ("reference", jio.load_png)):
            t0 = time.perf_counter()
            imgs[name] = fn(path)
            times[name] = time.perf_counter() - t0
    same = np.array_equal(imgs["port"], imgs["reference"])
    print(f"{side}x{side} RGB PNG, rows in filters 0-4: reference "
          f"{times['reference']!r} s, port {times['port']!r} s, equal "
          f"{same}; host CPU {_build._host_tag()}")
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
