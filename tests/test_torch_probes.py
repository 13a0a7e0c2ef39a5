"""The port's probe scripts (fovtrace_torch/scripts) against the JAX
package's TPU probes run by Pallas in interpret mode on the CPU.

The microbenchmark's six kernel bodies are closures inside
`scripts/microbench_inner.py:main`, whose first lines no longer run
against the JAX package (they read an older pack and schedule). So the
test parses the script and runs its own statements from `RB =
pi.RAY_BLOCK` on (`make_call`, the six bodies and their coefficient
specs, :68-227) on the port's inputs, with `pl.pallas_call` in interpret
mode and a `pi` that supplies the `_ray_slab` and `_MM` the script was
written against. `scripts/` is read, never changed.
"""

import ast
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from fovtrace.kernels import intersect as jisect  # noqa: E402
from fovtrace_torch.kernels import cluster_isect as ci  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402
from fovtrace_torch.scripts import MICRO_VARIANTS  # noqa: E402
from fovtrace_torch.scripts import microbench_inner as mb  # noqa: E402
from fovtrace_torch.scripts import probe_smem_dma as dma  # noqa: E402

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once; PyTorch's
    # default of one thread per core then oversubscribes the CPU
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# The script's `pi._MM` and `pi._ray_slab`, as committed in 308cae3,
# fovtrace/kernels/pallas_isect.py:60-65 and :279-305; both were removed
# from the JAX package in the commit that added the script.
_MM = dict(
    dimension_numbers=(((1,), (0,)), ((), ())),
    preferred_element_type=jnp.float32,
    precision=jax.lax.Precision.HIGHEST,   # true f32 on the MXU
)


def _ray_slab(rays_ref, cb_ref, jc, upper):
    ox = rays_ref[:, 0:1]
    oy = rays_ref[:, 1:2]
    oz = rays_ref[:, 2:3]
    ix = rays_ref[:, 12:13]
    iy = rays_ref[:, 13:14]
    iz = rays_ref[:, 14:15]
    tmin = rays_ref[:, 10:11]
    base = jc * 8
    lox = (cb_ref[base + 0] - ox) * ix
    hix = (cb_ref[base + 3] - ox) * ix
    loy = (cb_ref[base + 1] - oy) * iy
    hiy = (cb_ref[base + 4] - oy) * iy
    loz = (cb_ref[base + 2] - oz) * iz
    hiz = (cb_ref[base + 5] - oz) * iz
    tenter = jnp.maximum(
        jnp.maximum(jnp.minimum(lox, hix), jnp.minimum(loy, hiy)),
        jnp.maximum(jnp.minimum(loz, hiz), tmin),
    )
    texit = jnp.minimum(
        jnp.minimum(jnp.maximum(lox, hix), jnp.maximum(loy, hiy)),
        jnp.minimum(jnp.maximum(loz, hiz), upper),
    )
    return jnp.any(tenter <= texit)


class _Interpret:
    """`pl` with pallas_call in interpret mode; `outs` collects what each
    call returns."""

    def __init__(self):
        self.outs = []

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, *a, **kw):
        f = pl.pallas_call(*a, interpret=True, **kw)

        def call(*args):
            out = f(*args)
            self.outs.append(out)
            return out
        return call


@pytest.fixture(scope="module")
def micro_inputs():
    # 4 ray blocks: a 32x32 camera in 16x16 tiles
    return mb.build_inputs(procedural.earth_scene("cpu"), 32, 32)


@pytest.fixture(scope="module")
def script_outputs(micro_inputs):
    """{variant: [N, 1]} from the script's own bodies in interpret mode."""
    tree = ast.parse((SCRIPTS / "microbench_inner.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    start = next(i for i, s in enumerate(main.body)
                 if isinstance(s, ast.Assign)
                 and getattr(s.targets[0], "id", None) == "RB")
    code = compile(ast.Module(body=main.body[start:], type_ignores=[]),
                   str(SCRIPTS / "microbench_inner.py"), "exec")
    inp = micro_inputs
    outs = {}
    order = iter(MICRO_VARIANTS)    # the script times them in this order

    def timeit(fn, *args, name=""):
        out = jax.block_until_ready(fn(*args))
        outs[next(order)] = np.asarray(out)
        return 0.0, out

    pi = types.SimpleNamespace(RAY_BLOCK=ci.RAY_BLOCK, DET_EPS=jisect.DET_EPS,
                               _MM=_MM, _ray_slab=_ray_slab)
    ns = dict(jax=jax, jnp=jnp, pl=_Interpret(), pltpu=pltpu, pi=pi,
              timeit=timeit, nb=inp.nb, nc=inp.nc, c=inp.c,
              counts=jnp.asarray(inp.counts.numpy()),
              sched=jnp.asarray(inp.sched.numpy()),
              cb_flat=jnp.asarray(inp.cb_flat.numpy()),
              rays=jnp.asarray(inp.rays.numpy()),
              coef=jnp.asarray(inp.coef_lane.numpy()))
    exec(code, ns)
    assert sorted(outs) == sorted(MICRO_VARIANTS)
    return outs


@pytest.mark.parametrize("variant", MICRO_VARIANTS)
def test_micro_plain_matches_script_body(micro_inputs, script_outputs,
                                         variant):
    inp = micro_inputs
    stats = {}
    got = mb.plain(variant, *inp.args(variant), stats=stats).numpy()
    want = script_outputs[variant]
    assert got.shape == want.shape == (inp.nb * ci.RAY_BLOCK, 1)
    assert np.isfinite(got).all()
    if variant in ("loop", "slab"):
        # sums of small integers and halvings: exact in any order
        np.testing.assert_array_equal(got, want)
        return
    if variant == "full":
        hit = want < 1e30
        assert (hit == (got < 1e30)).all(), "hit/miss flips"
        assert hit.sum() > 100
        assert 0 < stats["steps"] <= int(inp.counts.sum())
        # float32 dot products summed in another order, then a division
        np.testing.assert_allclose(got[hit], want[hit], rtol=1e-5, atol=1e-5)
        return
    # raw float32 dot products (bf16 operands: exact products), summed in
    # another order; the minimum is of values up to ~100
    assert stats["steps"] == int(inp.counts.sum())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_micro_input_layouts(micro_inputs):
    inp = micro_inputs
    nc, c = inp.nc, inp.c
    earth = procedural.earth_scene("cpu")
    # the lane layout's cluster j columns are the leading layout's slab j
    lane = inp.coef_lane.view(16, nc, 4 * c).permute(1, 0, 2)
    assert torch.equal(lane, inp.coef_lead)
    assert torch.equal(inp.coef_lead, earth.isect_coef)
    assert torch.equal(inp.coef_bf16.float(),
                       earth.isect_coef.to(torch.bfloat16).float())
    assert torch.equal(inp.cb_flat.view(nc, 8), earth.cluster_aabb)
    # rays are pack_raysT's blocks transposed to rows
    raysT = inp.rays.view(inp.nb, ci.RAY_BLOCK, 16).permute(0, 2, 1)
    live, _ = ci.block_liveness(raysT.contiguous(), earth.cluster_aabb)
    row = inp.sched.view(inp.nb, nc).long()
    for i in range(inp.nb):
        ids = row[i]
        # each row holds every cluster once, its live ones first
        assert torch.equal(ids.sort().values, torch.arange(nc))
        n = int(inp.counts[i])
        assert n == int(live[i].sum()) > 0
        assert set(ids[:n].tolist()) == set(torch.nonzero(live[i])
                                            .squeeze(1).tolist())


def test_smem_dma_plain_matches_script_kernel(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "_probe_smem_dma_script", SCRIPTS / "probe_smem_dma.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    interp = _Interpret()
    monkeypatch.setattr(script, "pl", interp)
    script.main()                   # its own numpy check, err < 1e-3
    (pallas_out,) = interp.outs
    arrays = dma.make_inputs()
    got = dma.smem_dma(*(torch.from_numpy(a) for a in arrays)).numpy()
    ref = dma.numpy_reference(*arrays)
    # the plain version rounds exactly as the numpy check (a multiply,
    # then an add, per entry in order)
    np.testing.assert_array_equal(got, ref)
    # XLA on the CPU may contract the multiply-add; values reach ~1e4
    np.testing.assert_allclose(got, np.asarray(pallas_out), rtol=1e-5,
                               atol=1e-3)
    assert np.abs(got - np.asarray(pallas_out)).max() < 1e-3


def test_smem_dma_plain_other_shape():
    # the city G-buffer's row plumbing at a small block count: NSC 666,
    # SW 768, 16 blocks
    arrays = dma.make_inputs(nb=16, nsc=666, sw=768, seed=3)
    got = dma.smem_dma(*(torch.from_numpy(a) for a in arrays)).numpy()
    np.testing.assert_array_equal(got, dma.numpy_reference(*arrays))


def test_probe_mains_run_on_cpu(capsys):
    assert dma.main(["--device", "cpu"]) == 0
    assert "OK" in capsys.readouterr().out
    assert mb.main(["--device", "cpu", "--width", "32", "--height", "32",
                    "--iters", "1"]) == 0
    err = capsys.readouterr().err
    assert "[micro] nb=4 nc=44 c=128" in err
    assert err.count("ns per live step") == len(MICRO_VARIANTS)


@pytest.mark.parametrize("probe", ["micro", "smem_dma"])
def test_probe_wrappers_raise_off_cpu_and_cuda(micro_inputs, probe):
    meta = lambda t: torch.empty_like(t, device="meta")
    if probe == "micro":
        args = [meta(t) for t in micro_inputs.args("full")]
        with pytest.raises(ValueError, match="cpu or cuda"):
            mb.run_variant("full", *args)
    else:
        args = [meta(torch.from_numpy(a)) for a in dma.make_inputs()]
        with pytest.raises(ValueError, match="cpu or cuda"):
            dma.smem_dma(*args)


def test_probe_wrappers_check_shapes(micro_inputs):
    inp = micro_inputs
    with pytest.raises(ValueError, match="variant"):
        mb.run_variant("mm", *inp.args("full"))
    with pytest.raises(ValueError, match="needs coefficients"):
        mb.run_variant("full", *inp.args("loop"))
    with pytest.raises(ValueError, match=r"\[16, NC \* 4c\]"):
        mb.run_variant("mm_lane", *inp.args("mm_lead"))
    with pytest.raises(TypeError, match="bfloat16"):
        mb.run_variant("mm_bf16", *inp.args("mm_lead"))
    counts, sched, rays, table = (torch.from_numpy(a)
                                  for a in dma.make_inputs())
    with pytest.raises(ValueError, match="multiple of 8"):
        dma.smem_dma(counts[:12], sched[:12], rays[:12], table)
    with pytest.raises(ValueError, match="multiple of 4"):
        dma.smem_dma(counts, sched[:, :126].contiguous(), rays, table)
