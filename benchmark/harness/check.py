"""The numbers that decide `correct`, each compared with its limit.

A viewer frame (the program's against the reference's, both on the host):

  depth_bad    share of pixels whose G-buffer depth (the depth cache
               carried to the next frame) misses or hits on one side only,
               or differs by more than 1e-4 of the reference's
  gbuf_bad     share of pixels where any G-buffer plane differs: position
               by more than 1e-4 x max(1, |p|), normal or albedo by more
               than 1e-4, shadow at all (single-card cells)
  mask_bad     share of pixels whose sample mask differs (single-card)
  ray_count_gap
               |program - reference| / reference of the frame's sampled
               pixels (the mask's count)
  history_bad  share of pixels whose carried history (accumulated rgb and
               sample count) differs by more than 1e-3 x max(1, |ref|)
  image_bad    share of pixels whose A-Trous image differs by more than
               1e-3 in any channel

A train run (`train_numbers`): loss_gap, the largest |L - L_ref| / L_ref
over the checked steps; grad_gap and change_gap, by the worst leaf, the
gap between the program's and the reference's norm of the first gradient
and of the parameters' change after the checked steps, over the larger of
that leaf's reference norm and the median leaf's. Leaves whose reference
gradient is under a thousandth of the median leaf's are left out.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

TOL_DEPTH = 1e-4
TOL_POS = 1e-4
TOL_DIR = 1e-4
TOL_HISTORY = 1e-3
TOL_IMAGE = 1e-3


def _share(bad: torch.Tensor) -> float:
    return float(bad.to(torch.float64).mean())


def _off(p: torch.Tensor, r: torch.Tensor, tol) -> torch.Tensor:
    """Elements farther apart than tol; a non-finite value on one side
    only is off, the same non-finite value on both is not."""
    same = (p == r) | (torch.isnan(p) & torch.isnan(r))
    return ~same & ~((p - r).abs() <= tol)


def _gap(p, r) -> float:
    """|p - r| / |r|; inf where either side is not finite (max() would
    pass over a NaN that is not first)."""
    p, r = float(p), float(r)
    g = abs(p - r) / max(abs(r), 1e-30)
    return g if math.isfinite(g) else math.inf


def view_numbers(p: dict, r: dict) -> dict:
    """The frame's numbers from two dicts of host tensors with the same
    keys: depth [H, W], history [4, H, W], image [3, H, W], ray_count,
    and where both have them gbuf {position, normal,
    albedo: [3, H, W], shadow: [H, W]} and mask [H, W]."""
    dp, dr = p["depth"], r["depth"]
    hp, hr = dp > 0.0, dr > 0.0
    depth_bad = (hp != hr) | _off(dp, dr, TOL_DEPTH * dr.abs())
    out = {"depth_bad": _share(depth_bad)}
    if "gbuf" in p and "gbuf" in r:
        gp, gr = p["gbuf"], r["gbuf"]
        pos = _off(gp["position"], gr["position"],
                   TOL_POS * gr["position"].abs().clamp_min(1.0)).any(0)
        nrm = _off(gp["normal"], gr["normal"], TOL_DIR).any(0)
        alb = _off(gp["albedo"], gr["albedo"], TOL_DIR).any(0)
        sh = _off(gp["shadow"], gr["shadow"], 0.0)
        out["gbuf_bad"] = _share(pos | nrm | alb | sh)
    if "mask" in p and "mask" in r:
        out["mask_bad"] = _share(p["mask"] != r["mask"])
    out["ray_count_gap"] = _gap(p["ray_count"], r["ray_count"])
    hb = _off(p["history"], r["history"],
              TOL_HISTORY * r["history"].abs().clamp_min(1.0)).any(0)
    out["history_bad"] = _share(hb)
    ib = _off(p["image"], r["image"], TOL_IMAGE).any(0)
    out["image_bad"] = _share(ib)
    return out


def worst(numbers: list) -> dict:
    """Each number's largest reading over several frames or steps."""
    out = {}
    for d in numbers:
        for k, v in d.items():
            out[k] = max(out.get(k, v), v)
    return out


def _leaf_gap(prog, ref, keep) -> float:
    """max over kept leaves of |norm_p - norm_r| / max(norm_r, median)."""
    np_ = [float(torch.linalg.vector_norm(t.double())) for t in prog]
    nr = [float(torch.linalg.vector_norm(t.double())) for t in ref]
    kept = [i for i in range(len(nr)) if keep[i]]
    med = sorted(nr[i] for i in kept)[len(kept) // 2]
    gaps = [abs(np_[i] - nr[i]) / max(nr[i], med, 1e-30) for i in kept]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def kept_leaves(ref_grads) -> list:
    """Leaves whose reference gradient norm is at least a thousandth of
    the median leaf's: the others move under Adam by round-off alone. A
    leaf whose norm is not finite is kept."""
    n = [float(torch.linalg.vector_norm(g.double())) for g in ref_grads]
    med = sorted(n)[len(n) // 2]
    return [not x < 1e-3 * med for x in n]


def train_numbers(p: dict, r: dict) -> dict:
    """p, r: {losses: [float], grad1: [leaf tensors], change: [leaf
    tensors]} (host tensors, the same leaf order)."""
    keep = kept_leaves(r["grad1"])
    return {
        "loss_gap": max(_gap(a, b) for a, b in zip(p["losses"],
                                                     r["losses"])),
        "grad_gap": _leaf_gap(p["grad1"], r["grad1"], keep),
        "change_gap": _leaf_gap(p["change"], r["change"], keep),
    }


def limits_of(root: Path, cell: str) -> dict:
    """{number: limit} of a cell, benchmark/limits/<cell>.json."""
    return json.loads((root / "limits" / f"{cell}.json").read_text())[
        "limits"]


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit, and every limit read."""
    shown = {k: {"value": numbers.get(k), "limit": lim}
             for k, lim in limits.items()}
    ok = all(v["value"] is not None and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown
