"""The SASS instruction-mix reader (fovtrace_torch/scripts/sass_mix.py) on
a hand-written `cuobjdump -sass` listing: kernel names, the innermost
FFMA loops and their per-pair counts. The script reads the card's own
listings (`python -m fovtrace_torch.scripts.sass_mix` on the card)."""

import pytest
import torch

from fovtrace_torch.scripts import sass_mix



def _insn(addr, text):
    return f"        /*{addr:04x}*/                   {text} ;\n"


def _listing():
    """Two kernels: a streaming one whose loop 0x10.. holds an inner
    loop of one pair (40 FFMA, an LDS.128 and an LDS, a MUFU.RCP, two
    others), and a resident one whose only loop holds 40 FFMA."""
    out = ["        Function : _ZN12_GLOBAL__N_121closest_stream_kernelILi4EEE"
           "vPKfS2_PKiS4_S2_PfPiS6_S6_iiii\n",
           '        .headerflags    @"EF_CUDA_SM90"\n']
    body = ["LDC R1, c[0x0][0x28]", "S2R R0, SR_TID.X", "LDS.128 R4, [R2]"]
    body += ["FFMA R8, R4, R5, R8"] * 40
    body += ["LDS R10, [R2+0x10]", "MUFU.RCP R11, R9",
             "FSETP.GT.AND P0, PT, R8, R11, PT"]
    insns = [_insn(16 * i, t) for i, t in enumerate(body)]
    n = len(body)
    insns.append(_insn(16 * n, "@P0 BRA 0x20"))           # inner loop
    insns.append(_insn(16 * (n + 1), "IADD3 R2, R2, 0xa0, RZ"))
    insns.append(_insn(16 * (n + 2), "@!P1 BRA 0x10"))    # outer loop
    insns.append(_insn(16 * (n + 3), "EXIT"))
    out += insns
    out.append("        Function : _ZN12_GLOBAL__N_114closest_kernelEPKfS1_"
               "PKiS3_S1_PfPiS5_ii\n")
    out += [_insn(16 * i, "FFMA R1, R2, R3, R4") for i in range(40)]
    out.append(_insn(16 * 40, "BRA 0x0"))
    return "".join(out)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_parse_and_name():
    funcs = sass_mix.parse(_listing())
    assert len(funcs) == 2
    names = sorted(sass_mix.short_name(k) for k in funcs)
    assert names == ["closest_kernel", "closest_stream_kernel<4>"]
    stream = next(v for k, v in funcs.items() if "stream" in k)
    assert [op for _, op, _ in stream][:3] == ["LDC", "S2R", "LDS.128"]
    assert stream[46][:2] == (0x2e0, "BRA")
    assert len(stream) == 50


def test_inner_loop_counts():
    funcs = sass_mix.parse(_listing())
    stream = next(v for k, v in funcs.items() if "stream" in k)
    loops = sass_mix.inner_loops(stream)
    # the loop 0x10-0x300 holds the loop 0x20-0x2e0: only the inner counts
    assert len(loops) == 1
    lp = loops[0]
    assert (lp["lo"], lp["hi"], lp["n"]) == (0x20, 0x2e0, 45)
    assert lp["counts"] == {"LDS": 2, "FFMA": 40, "MUFU.RCP": 1, "other": 2}
    # no branch before the loop's own: the head is the whole body
    assert lp["head_n"] == 45 and lp["head"] == lp["counts"]
    resident = next(v for k, v in funcs.items() if "stream" not in k)
    assert [(x["lo"], x["hi"]) for x in sass_mix.inner_loops(resident)] == \
        [(0, 0x280)]
    # fewer than one pair's 40 FFMAs: not a pair loop
    assert sass_mix.inner_loops(resident[1:]) == []


def test_report_covers_every_kernel(monkeypatch, capsys):
    """The report reads every kernel of a library, the resident pair as
    well as the streaming one, with one line per pair loop."""
    monkeypatch.setattr(sass_mix, "functions",
                        lambda lib: sass_mix.parse(_listing()))
    res = sass_mix.report("lib.so")
    assert sorted(res) == ["closest_kernel", "closest_stream_kernel<4>"]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all(ln.startswith("[sass] lib.so ")
                                   for ln in lines)
    assert "pairs per iteration 1; per pair FFMA 40.00" in lines[1]
    assert "pairs per iteration 0; per pair FFMA n/a" in lines[0]


def _probe_listing():
    """The probe library's bodies: micro_kernel<4> (mm_bf16) whose loop
    holds 32 HMMA and no FFMA, micro_kernel<2> (mm_lane) whose loop holds
    four pairs' 160 FFMA, and a copy kernel with no pair loop."""
    out = []
    for v, body in ((4, ["LDS.128 R4, [R2]"]
                     + ["HMMA.16816.F32.BF16 R8, R4, R6, R8"] * 32
                     + ["FMNMX R0, R8, R0, PT"] * 128),
                    (2, ["LDS.128 R4, [R2]"] * 10
                     + ["FFMA R8, R4, R5, R8"] * 160)):
        out.append(f"        Function : _ZN41_GLOBAL__N__f787fa35_9_probes_cu"
                   f"_9ea646c712micro_kernelILi{v}EEEvNS_9MicroArgsE\n")
        out += [_insn(16 * i, t) for i, t in enumerate(body)]
        out.append(_insn(16 * len(body), "@P0 BRA 0x0"))
    out.append("        Function : _ZN41_GLOBAL__N__f787fa35_9_probes_cu_9ea6"
               "46c715smem_dma_kernelILi2ELb1EEEvPKiS2_PKfS4_PKxPfiii\n")
    out += [_insn(0, "LDS R1, [R2]"), _insn(16, "FADD R3, R3, R1"),
            _insn(32, "@P0 BRA 0x0")]
    return "".join(out)


def test_probe_bodies_count_hmma(monkeypatch, capsys):
    """A loop of HMMAs is a pair loop with no FFMA; the probe bodies
    count a pair per HMMA (mm_bf16) or per 40 FFMAs (mm_lane), the
    cluster kernels one per MUFU.RCP."""
    funcs = sass_mix.parse(_probe_listing())
    by = {sass_mix.short_name(k): v for k, v in funcs.items()}
    assert sorted(by) == ["micro_kernel<2>", "micro_kernel<4>",
                          "smem_dma_kernel"]
    bf16, = sass_mix.inner_loops(by["micro_kernel<4>"])
    assert bf16["counts"] == {"LDS": 1, "HMMA": 32, "other": 129}
    assert sass_mix.inner_loops(by["smem_dma_kernel"]) == []
    assert sass_mix.pair_rule("micro_kernel<4>") is sass_mix.probe_pairs
    assert sass_mix.pair_rule("closest_kernel") is sass_mix.rcp_pairs
    monkeypatch.setattr(sass_mix, "functions",
                        lambda lib: sass_mix.parse(_probe_listing()))
    res = sass_mix.report("probes.so")
    assert [lp["pairs"] for lp in res["micro_kernel<4>"]] == [32]
    assert [lp["pairs"] for lp in res["micro_kernel<2>"]] == [4]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert "0 FFMA, 1 LDS, 32 HMMA" in lines[1]
    assert "pairs per iteration 32; per pair FFMA 0.00, LDS 0.03, HMMA " \
        "1.00, other 4.03" in lines[1]
    assert "pairs per iteration 4; per pair FFMA 40.00, LDS 2.50" in lines[0]
