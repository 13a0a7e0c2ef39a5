"""Wavefront path tracing (counterpart of `fovtrace/render/shade.py`).

A bounded bounce loop over the whole ray front: each bounce intersects
every live ray once, evaluates the diffuse (NEE + cosine GI), mirror
(phong + Schlick) and glass (Fresnel-chosen single successor, Beer)
models densely, and selects by material kind. Between bounces the
survivors are compacted, direction octant major, into a static budget
(`config.bounce_budget_fracs` of the first width, floor 1024); overflow
is dropped. The RNG draw order is the reference's, so the same seeds
give the same paths.
"""

from __future__ import annotations

import math

import torch

from reference import mathx, rng, vec
from reference.vec import Vec3
from reference import envmap as envmap_k
from reference import intersect as isect


def envmap_texel_coords(dirs: Vec3, h: int, w: int):
    """(fx, fy): the continuous texel coordinates of each direction on an
    [h, w] lat-long map (u = 0 at theta = -pi, v = 1 at the top).

    v = 0.5 (1 + sin(pi/2 - acos y)) is 0.5 (1 + y), so dv/dy = 0.5
    everywhere; but acos'(+-1) is infinite, and a direction whose y rounds
    to +-1 (a mirror ray off a level normal) would carry an infinite
    gradient into the shading normal. On those pole lanes acos takes y
    detached, so the forward is the same formula bit for bit, and v gets
    its gradient 0.5 from `0.5 (y - y.detach())`, which adds 0; off the
    poles the gradient is the formula's, bit for bit. The JAX package's
    `arccos` gives -inf there."""
    theta = torch.atan2(dirs.x, dirs.z)
    y = torch.clamp(dirs.y, -1.0, 1.0)
    pole = y.abs() >= 1.0
    # torch.where's backward selects, so acos's infinite slope at the
    # poles reaches no lane: pole lanes take their gradient from `lin`
    phi = math.pi * 0.5 - torch.acos(torch.where(pole, y.detach(), y))
    u = (theta + math.pi) * (0.5 / math.pi)
    lin = torch.where(pole, 0.5 * (y - y.detach()), 0.0)
    v = 0.5 * (1.0 + torch.sin(phi)) + lin
    return u * (w - 1), (1.0 - v) * (h - 1)


def envmap_lookup_v(envmap: torch.Tensor, dirs: Vec3, scale: float = 2.0
                    ) -> Vec3:
    """Bilinear, edge-clamped lat-long environment lookup."""
    fx, fy = envmap_texel_coords(dirs, envmap.shape[0], envmap.shape[1])
    rgb = envmap_k.lookup_plain(fx.reshape(-1), fy.reshape(-1), envmap,
                                scale)
    return Vec3(*(c.view(fx.shape) for c in rgb))


def nee_direct_v(scene, point: Vec3, normal: Vec3, kd: Vec3, seeds, config,
                 ks: Vec3, phong_exp, wo: Vec3, enabled):
    """Next-event estimation: one light sample and one shadow ray per
    hit. Returns (diffuse radiance, phong radiance, new seeds); the
    caller selects per material kind."""
    light = scene.light
    z1, seeds = rng.rnd(seeds)
    z2, seeds = rng.rnd(seeds)
    light_pos = vec.fma(vec.of(light.v2), z2,
                        vec.fma(vec.of(light.v1), z1, vec.of(light.corner)))
    to_l = light_pos - point
    ldist = vec.length(to_l)
    l = to_l * (1.0 / torch.clamp_min(ldist, 1e-20))
    ln = vec.of(light.normal)
    ndl = vec.dot(normal, l)
    lndl = vec.dot(ln, l)
    facing = (ndl > 0.0) & (lndl > 0.0)
    # disabled lanes (misses, dead rays) get t_max = -1: culled
    shadow_tmax = torch.where(enabled & facing, ldist - config.scene_epsilon,
                              -1.0)
    atten = isect.occlusion_v(scene, vec.fma(normal, config.scene_epsilon,
                                             point), l,
                              config.scene_epsilon, shadow_tmax)
    weight = ndl * lndl * light.area / (math.pi * ldist * ldist)
    lc = vec.of(light.emission) * weight * atten

    diffuse = kd * lc
    phong = kd * lc * ndl
    h = vec.normalize(l - wo)
    ndh = vec.dot(normal, h)
    spec = torch.where(ndh > 0.0, torch.clamp_min(ndh, 1e-9) ** phong_exp,
                       0.0)
    phong = vec.fma(ks * lc, spec, phong)
    return (vec.where(facing, diffuse, 0.0), vec.where(facing, phong, 0.0),
            seeds)


def _bounce(scene, config, bounce, origin, direction, throughput, seeds,
            gi_depth, alive):
    """One wavefront bounce -> (radiance to add, continuation state,
    rays traced, first-hit capture on bounce 0)."""
    from reference.scene import (MATL_DIFFUSE, MATL_REFLECTION,
                                            MATL_REFRACTION)

    t_max = torch.where(alive, isect.BIG_T, -1.0)
    hit, surf = isect.intersect_surface_v(
        scene, origin, direction, config.scene_epsilon, t_max)
    missed = alive & ~hit.valid
    env = envmap_lookup_v(scene.envmap, direction, config.envmap_scale)
    add = vec.where(missed, throughput * env, 0.0)
    point = surf["point"]
    n_sh = vec.faceforward(surf["normal"], -direction, surf["gnormal"])
    kd = surf["kd"]
    mat_id = surf["mat_id"]
    (kind_f, ks, pexp, refl_n, ior, extinction, refr_color, refl_color,
     fres_exp, fres_min, fres_max) = isect.material_lookup_v(
        scene.materials, mat_id.clamp_min(0),
        [("kind", 1), ("ks", 3), ("phong_exp", 1), ("reflectivity_n", 3),
         ("ior", 1), ("extinction", 3), ("refraction_color", 3),
         ("reflection_color", 3), ("fresnel_exponent", 1),
         ("fresnel_minimum", 1), ("fresnel_maximum", 1)])
    kind = torch.where(mat_id >= 0, kind_f.to(torch.int32), -1)

    live_hit = alive & hit.valid
    traced = alive.sum() + live_hit.sum()

    # NEE direct lighting (diffuse and phong variants)
    direct_d, direct_r, seeds = nee_direct_v(
        scene, point, n_sh, kd, seeds, config, ks=ks, phong_exp=pexp,
        wo=direction, enabled=live_hit)
    cos_i = torch.clamp_min(-vec.dot(n_sh, direction), 0.0)
    r_schlick = vec.schlick_rgb(cos_i, refl_n)

    # refraction: Fresnel split, single successor
    t_dir, tir = vec.refract(direction, surf["normal"], ior)
    cos_n = vec.dot(direction, surf["normal"])
    cos_theta = torch.where(cos_n < 0.0, -cos_n,
                            vec.dot(t_dir, surf["normal"]))
    c1 = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    fres = torch.clamp(mathx.fma(fres_max - fres_min, c1 ** fres_exp,
                                 fres_min), 0.0, 1.0)
    fres = torch.where(tir, 1.0, fres)
    exiting = cos_n > 0.0
    beer = vec.where(exiting, vec.exp(extinction * surf["t_safe"]), 1.0)
    zr, seeds = rng.rnd(seeds)
    choose_refl = zr < fres
    refr_dir = vec.where(choose_refl, vec.reflect(direction, surf["normal"]),
                         t_dir)
    refr_weight = vec.where(choose_refl, refl_color, refr_color) * beer * kd

    is_diff = live_hit & (kind == MATL_DIFFUSE)
    is_refl = live_hit & (kind == MATL_REFLECTION)
    is_refr = live_hit & (kind == MATL_REFRACTION)
    direct = vec.where(is_diff, direct_d, 0.0) + vec.where(is_refl, direct_r,
                                                           0.0)
    add = vec.fma(throughput, direct, add)

    # continuation ray
    z1, seeds = rng.rnd(seeds)
    z2, seeds = rng.rnd(seeds)
    lx, ly, lz = vec.cosine_sample_hemisphere(z1, z2)
    gi_dir = vec.to_world(lx, ly, lz, n_sh)
    mirror_dir = vec.reflect(direction, n_sh)
    new_dir = vec.where(is_refr, refr_dir,
                        vec.where(is_refl, mirror_dir, gi_dir))
    new_thr = throughput * vec.where(
        is_refr, refr_weight, vec.where(is_refl, r_schlick, kd))

    # survival: diffuse by depth, specular by importance
    importance = vec.luminance(vec.abs_(new_thr))
    diff_go = is_diff & (gi_depth < config.diffuse_max_depth - 1)
    spec_go = (is_refl | is_refr) & (importance > config.importance_cutoff)
    go = diff_go | spec_go

    side = torch.where(vec.dot(new_dir, surf["gnormal"]) >= 0.0, 1.0, -1.0)
    new_origin = vec.fma(surf["gnormal"], side * config.scene_epsilon, point)
    origin = vec.where(go, new_origin, origin)
    direction = vec.where(go, new_dir, direction)
    throughput = vec.where(go, new_thr, throughput)
    gi_depth = torch.where(is_diff & go, gi_depth + 1, gi_depth)
    first = (point, n_sh, hit.t, hit.valid) if bounce == 0 else None
    return (add, origin, direction, throughput, seeds, gi_depth, go, traced,
            first)


def shade_v(scene, ro: Vec3, rd: Vec3, seeds: torch.Tensor, config,
            active: torch.Tensor | None = None):
    """Radiance for a flat front of rays.

    ro, rd: Vec3 of [N]; seeds: [N] int64 RNG states. Returns (radiance
    Vec3 of [N], aux dict: first-hit point/normal/t and rays_traced).

    `active` ([N] bool) marks the lanes that carry a pixel's ray; the
    rest pad a compacted front to its static budget. Every lane is traced
    in the first bounce, as the reference traces (and counts) them, but
    only active lanes continue: the reference lets the padding lanes,
    copies of one pixel's ray, go on bouncing, where they can crowd the
    real survivors out of the next bounce's budget."""
    from reference import sampling

    n = ro.x.shape[0]
    dev = ro.x.device
    # one sink slot at index n takes the adds of inactive lanes
    result = vec.zeros((n + 1,), dev)
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    aux = {}

    origin, direction = ro, rd
    throughput = vec.full((n,), 1.0, dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    gi_depth = torch.zeros((n,), dtype=torch.int32, device=dev)

    body = _bounce
    for bounce in range(config.max_depth):
        (add, origin, direction, throughput, seeds, gi_depth, alive, traced,
         first) = body(scene, config, bounce, origin, direction, throughput,
                       seeds, gi_depth, alive)
        rays_traced = rays_traced + traced
        if bounce == 0 and active is not None:
            alive = alive & active
        result = Vec3(result.x.index_add(0, pix, add.x),
                      result.y.index_add(0, pix, add.y),
                      result.z.index_add(0, pix, add.z))
        if bounce == 0:
            point, n_sh, t0, valid0 = first
            aux["point"] = vec.where(valid0, point, 0.0)
            aux["normal"] = vec.where(valid0, n_sh, 0.0)
            aux["t"] = torch.where(valid0, t0, isect.BIG_T)

        # compact the survivors, octant major, for the next bounce
        if bounce + 1 < config.max_depth:
            width = origin.x.shape[0]
            fracs = config.bounce_budget_fracs
            budget = int(n * fracs[min(bounce, len(fracs) - 1)])
            budget = min(max(1024, (budget + 1023) // 1024 * 1024), width)
            if budget < width:
                idx, active, rankc, gatec = sampling.compact_mask_keyed_rank(
                    alive, sampling.direction_octant(direction), 8, budget)
                rows = torch.stack([origin.x, origin.y, origin.z,
                                    direction.x, direction.y, direction.z,
                                    throughput.x, throughput.y,
                                    throughput.z], dim=-1)
                cols = sampling.compact_gather(rows, idx, rankc, gatec).T
                origin = Vec3(cols[0], cols[1], cols[2])
                direction = Vec3(cols[3], cols[4], cols[5])
                throughput = Vec3(cols[6], cols[7], cols[8])
                seeds = seeds[idx]
                gi_depth = gi_depth[idx]
                pix = torch.where(active, pix[idx], n)
                # every active slot came from an alive lane
                alive = active

    aux["rays_traced"] = rays_traced
    return result.map(lambda a: a[:n]), aux
