"""Hybrid step renderer: nearest-hit kernels outside, one fused step kernel
for everything else. Port of `miniraytracer_tpu/ops/hybrid.py`
(`render_wavefront_hybrid`, `make_workqueue_shader` and what they run).

The fused render (`ops/bounce.py`) covers scenes whose tables stay small: at
most 64 primitives a type, 24 materials, no image texture. The machinery here
covers the scenes beyond it: random_spheres (~490 spheres, a material each),
earth (an image texture), book2_final (1006 spheres and 400 boxes), a
triangle set of more than 64 (triangles with its meshes: about 11,300). Each
step, all on the device:

1. the sweeps of `ops/flash.py` (kernels of `csrc/flash.cu`) find, for every
   lane, the nearest hit over the EXTERNAL sets: the sphere set and the
   triangle set that have more than 64 members (dense up to 511 spheres and
   1023 triangles, clustered beyond); a box set of more than 64 is swept by tensor operations
   (`intersect.box_ts`), as in the JAX package;
2. `_external_candidate` assembles the winner's record (normal, material) with
   plain tensor indexing. In ext-material mode (more materials or textures
   than the step kernel's tables hold) it also evaluates the winner's material
   from the scene's full tables;
3. ONE step kernel (`csrc/hybrid.cu`) takes that candidate as the seed of its
   in-table sweep and does the rest. For the pixel-pinned loop of this module
   (`render_wavefront_hybrid`) it is `hybrid_step`: `bounce.wave_step` with
   the remaining primitives, material dispatch, light sampling, merge,
   regeneration, and the image texel fetch. For the work queue
   (`models/integrator.py`) it is `shade_step`: the same bounce and advance
   without merge and regeneration, which the queue does globally.

Same estimator as the fused render: the same counter-keyed RNG, merge and
NaN/clamp policy. `hybrid_step_plain` and `shade_step_plain` are the step
kernels' plain PyTorch versions; the wrappers launch the kernels for CUDA
tensors and run the plain versions for CPU tensors.

The loop ends when no lane is alive, which the host reads once a step (a
step changes a dead lane's depth, so skipping the test for a few steps would
not leave the state as it was).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import time as _time

import numpy as np
import torch

from miniraytracer_tpu_torch.models import camera as cam_mod
from miniraytracer_tpu_torch.models import textures
from miniraytracer_tpu_torch.ops import bounce as B
from miniraytracer_tpu_torch.ops import flash
from miniraytracer_tpu_torch.ops import intersect as ix
from miniraytracer_tpu_torch.ops import noise
from miniraytracer_tpu_torch.ops import rng
from miniraytracer_tpu_torch.ops.vecmath import V3, vwhere
from miniraytracer_tpu_torch.scene import types as T
from miniraytracer_tpu_torch.utils import device

INF = B.INF

# state rows of the step (the JAX package's layout)
R_ACC, R_RO, R_RD, R_TIME, R_BETA, R_RAD, R_ALIVE = 0, 3, 6, 9, 10, 13, 16
NF = 17
I_COUNT, I_INSIDE, I_DEPTH = 0, 1, 2
NI = 3
# candidate rows handed to the step: (t, nx, ny, nz, mat_f), and in
# ext-material mode also (mtype, mparam, albedo r g b, texel index)
NE = 5
NE_MAT = 11

# rows of the work queue's shade step (the JAX package's layout): in
# ro(3) rd(3) time beta(3) radiance(3) depth_ok alive, out cont p(3) new_rd(3)
# beta(3) radiance(3)
SH_RO, SH_RD, SH_TIME, SH_BETA, SH_RAD, SH_DOK, SH_ALIVE = 0, 3, 6, 7, 10, 13, 14
SH_NF = 15
SO_CONT, SO_P, SO_RD, SO_BETA, SO_RAD = 0, 1, 4, 7, 10
SO_NF = 13

# Launches of the two step kernels (never of their plain versions).
step_launches = 0
shade_launches = 0


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _ext_types(scene: T.SceneData):
    """Which primitive types are intersected OUTSIDE the step kernel:
    (spheres, triangles, boxes) with more than 64 members."""
    return (scene.n_spheres > B.MAX_PRIMS, scene.n_tris > B.MAX_PRIMS,
            scene.has_boxes and scene.n_boxes > B.MAX_PRIMS)


def ext_mat_mode(scene: T.SceneData) -> bool:
    """True when the scene has more materials or textures than the step
    kernel's tables hold: the outside winner's material is then evaluated
    from the full tables and rides the candidate rows (random_spheres' ~490
    per-sphere materials)."""
    return (scene.mat_type.shape[0] > B.MAX_MATS
            or scene.tex_type.shape[0] > B.MAX_TEXS)


def _smem_mat_ids(scene: T.SceneData):
    """(material ids, texture ids, any) used by the primitives that stay in
    the step kernel's tables: what the compacted tables of ext-material mode
    must hold."""
    ext_sph, ext_tri, ext_box = _ext_types(scene)
    used: list = []

    def add(arr, act):
        used.extend(_np(arr)[_np(act).astype(bool)].tolist())

    if scene.n_spheres and not ext_sph:
        add(scene.sph_mat, scene.sph_active)
    if scene.n_rects:
        add(scene.rect_mat, scene.rect_active)
    if scene.n_tris and not ext_tri:
        add(scene.tri_mat, scene.tri_active)
    if scene.has_boxes and scene.n_boxes and not ext_box:
        add(scene.box_mat, scene.box_active)
    if scene.n_volumes:
        add(scene.vol_mat, scene.vol_active)
    mat_ids = sorted(set(int(v) for v in used)) or [0]
    tex_ids = sorted(set(int(v) for v in _np(scene.mat_tex)[mat_ids])) or [0]
    return mat_ids, tex_ids, bool(used)


def smem_plan(scene: T.SceneData):
    """Compaction plan of ext-material mode, as the JAX package's: which
    material and texture rows the step kernel's tables keep, and the
    primitives' material ids renumbered into them. A tuple of (name, value)
    pairs sorted by name."""
    mat_ids, tex_ids, any_used = _smem_mat_ids(scene)
    mat_pos = {m: i for i, m in enumerate(mat_ids)}
    tex_pos = {t: i for i, t in enumerate(tex_ids)}

    def rm(arr):
        return tuple(mat_pos.get(int(v), 0) for v in _np(arr).ravel())

    tex_type = _np(scene.tex_type)
    mat_tex = _np(scene.mat_tex)
    mat_img = tex_type[mat_tex] == T.TEX_IMAGE
    return (
        ("any_used", any_used),
        ("box_mat", rm(scene.box_mat)
         if scene.has_boxes and scene.n_boxes else None),
        ("ext_defer",
         bool(~(mat_img & (_np(scene.mat_type) == T.MAT_DIFFUSE_LIGHT)).any())),
        ("has_image_k",
         bool(any_used and (tex_type[tex_ids] == T.TEX_IMAGE).any())),
        ("mat_ids", tuple(mat_ids)),
        ("mat_tex", tuple(tex_pos.get(int(v), 0) for v in mat_tex[mat_ids])),
        ("rect_mat", rm(scene.rect_mat)),
        ("sph_mat", rm(scene.sph_mat)),
        ("tex_ids", tuple(tex_ids)),
        ("tri_mat", rm(scene.tri_mat)),
        ("vol_mat", rm(scene.vol_mat)),
    )


def _smem_scene(scene: T.SceneData, plan):
    """Copy of the scene with the material and texture tables compacted per
    `plan`, for packing only: the ext-material evaluation keeps reading the
    original scene."""
    p = dict(plan)
    dev = scene.device
    midx = torch.as_tensor(p["mat_ids"], dtype=torch.int64, device=dev)
    tidx = torch.as_tensor(p["tex_ids"], dtype=torch.int64, device=dev)
    ids = lambda v, like: torch.as_tensor(
        np.asarray(v, np.int32), device=dev).reshape(like.shape)
    # when no in-table primitive uses a material, the kept slot is a mere
    # placeholder: neutral, so that an image texture in it switches nothing on
    tex_type_k = (scene.tex_type[tidx] if p["any_used"]
                  else torch.zeros_like(scene.tex_type[tidx]))
    repl = dict(
        mat_type=scene.mat_type[midx], mat_param=scene.mat_param[midx],
        mat_tex=ids(p["mat_tex"], midx),
        tex_type=tex_type_k, tex_c0=scene.tex_c0[tidx],
        tex_c1=scene.tex_c1[tidx], tex_scale=scene.tex_scale[tidx],
        tex_img=scene.tex_img[tidx], has_image=p["has_image_k"],
    )
    for name in ("sph_mat", "rect_mat", "tri_mat", "vol_mat"):
        repl[name] = ids(p[name], getattr(scene, name))
    if p["box_mat"] is not None:
        repl["box_mat"] = ids(p["box_mat"], scene.box_mat)
    return dataclasses.replace(scene, **repl)


def can_hybrid(scene: T.SceneData) -> bool:
    """Step-kernel eligibility, the JAX package's rule: tables for everything
    except one big sphere set, one big triangle set and one big box set;
    scenes with more materials than the tables hold qualify through
    ext-material mode when the part the in-table primitives use fits."""
    ext_sph, ext_tri, ext_box = _ext_types(scene)
    if scene.n_rects > B.MAX_PRIMS or scene.n_volumes > B.MAX_VOLS:
        return False
    emat = ext_mat_mode(scene)
    if emat:
        mat_ids, tex_ids, _ = _smem_mat_ids(scene)
        if len(mat_ids) > B.MAX_MATS or len(tex_ids) > B.MAX_TEXS:
            return False
    if len(scene.lights) > B.MAX_LIGHTS:
        return False
    if ext_sph and any(lt == T.PRIM_SPHERE for lt, _ in scene.lights):
        return False  # the light pdf reads the in-table sphere set
    if scene.fast_perlin:
        return False
    if scene.has_image:
        # the kernel rebuilds the image uv from the winner normal, which is
        # right for spheres only; a primitive evaluated outside in
        # ext-material mode has its exact record
        img_mats = set(np.nonzero(
            _np(scene.tex_type)[_np(scene.mat_tex)] == T.TEX_IMAGE)[0].tolist())
        checks = [(scene.rect_mat, scene.rect_active)]
        if not (emat and ext_tri):
            checks.append((scene.tri_mat, scene.tri_active))
        if scene.has_boxes and scene.n_boxes and not (emat and ext_box):
            checks.append((scene.box_mat, scene.box_active))
        if scene.n_volumes:
            checks.append((scene.vol_mat, scene.vol_active))
        for arr, act in checks:
            live = _np(arr)[_np(act).astype(bool)]
            if live.shape[0] and img_mats & set(live.tolist()):
                return False
    return True


def prefer_hybrid(scene: T.SceneData) -> bool:
    """The JAX package's pick: the hybrid loop where it can run, except
    ext-material scenes with an image texture, whose winners pay a texture
    evaluation on every lane every step (capability is unchanged, only the
    default choice)."""
    return can_hybrid(scene) and not (ext_mat_mode(scene) and scene.has_image)


def pack_scene_hybrid(scene: T.SceneData, plan=None):
    """`bounce.pack_scene` with the external types taken out of the tables
    (count 0 and a one-word table: the step sees them only through the
    candidate rows). In ext-material mode the material and texture tables are
    compacted first (`smem_plan`)."""
    emat = ext_mat_mode(scene)
    if emat and plan is None:
        plan = smem_plan(scene)
    meta, tables = B.pack_scene(_smem_scene(scene, plan) if emat else scene)
    ext_sph, ext_tri, ext_box = _ext_types(scene)
    pad = torch.zeros((1,), dtype=torch.float32, device=scene.device)
    if emat:
        meta = dict(meta, ext_mat=True)
        if dict(plan)["ext_defer"] and scene.has_image:
            # a candidate's texel index addresses the whole atlas, whichever
            # textures the compacted tables kept
            meta = dict(meta, image=True, img_hw=tuple(
                int(d) for d in scene.images.shape[1:3]))
    if ext_sph:
        meta = dict(meta, S=0)
        tables[0] = pad
    if ext_tri:
        meta = dict(meta, Tc=0)
        tables[2] = pad
    if ext_box:
        meta = dict(meta, Bx=0)
        tables[3] = pad
    return meta, tables


def hybrid_accel(scene: T.SceneData):
    """What the sweeps over the external types need, by the JAX package's
    thresholds: "sph" the dense sphere tables (65..511 spheres), "sph_gate"
    or "sph_cull" the Morton clusters of `flash.sph_cull_build` (512..4095
    spheres: the gated sweep; more: the streamed one), "tri" the dense
    triangle tables (65..1023), "tri_cull" the Morton clusters of
    `flash.tri_cull_build` (1024 or more: the seeded clustered sweep). An
    external box set needs no entry."""
    ext_sph, ext_tri, _ = _ext_types(scene)
    accel = {}
    if ext_tri:
        if scene.n_tris >= ix.FLASH_CULL_MIN_TRIS:
            accel["tri_cull"] = flash.scene_tri_cull(scene)
        else:
            accel["tri"] = flash.scene_tri_coefficients(scene)
    if ext_sph:
        coeffs = flash.sphere_coefficients(scene)
        if scene.n_spheres < ix.FLASH_GATE_MIN_SPHERES:
            accel["sph"] = coeffs
        elif scene.n_spheres < ix.FLASH_CULL_MIN_SPHERES:
            accel["sph_gate"] = flash.sph_cull_build(scene, coeffs)
        else:
            accel["sph_cull"] = flash.sph_cull_build(scene, coeffs)
    return accel


def ext_coefficients(scene: T.SceneData, accel):
    """The coefficient tables of each sweep entry of `accel`
    (`hybrid_accel`), in scene order and with the scene's autograd history:
    what the differentiable sweeps give the gradient of their hit distance
    to (`_external_candidate` with `coeffs`)."""
    out = {}
    for key in accel:
        if key.startswith("sph"):
            out[key] = flash.sphere_coefficients(scene)
        else:
            out[key] = flash.scene_tri_coefficients(scene)
    return out


def _const_miss_rows(n, emat, device):
    """Candidate rows of a scene with no external type: the miss record
    (t = INF, n = (1,0,0), mat 0), in ext-material mode with the -1 material
    sentinel, no material and no texel."""
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    neg1 = z - 1.0
    rows = (z + INF, z + 1.0, z, z)
    if emat:
        return rows + (neg1, z, z, z, z, z, neg1)
    return rows + (z,)


def _external_candidate(scene, accel, rays: ix.Rays, alive, tmin, ptab=None,
                        plain=False, coeffs=None):
    """Sweep the external types (with the sweeps' plain versions if `plain`)
    and assemble the winner's record.

    With `coeffs` (`ext_coefficients`), the sweeps are the differentiable
    ones of `ops/flash.py` and the rows are differentiable in the rays, in
    those coefficient tables and in the scene's tensors that the records and
    the material read (the train step's candidate, `bounce_ad.ExtCandidate`);
    the values are the same.

    Dead lanes are fed NaN rays: no test on a NaN passes, so they come back
    as misses. Returns NE rows of (N,): (t, nx, ny, nz, mat_f) with t == INF
    where there is none; in ext-material mode NE_MAT rows, mat_f = -1 (no row
    of the step's compacted material table matches it) and the winner's
    material evaluated here from the full tables, the texture sampled at the
    record's exact uv (Perlin turbulence through kernel B6 without `plain`
    and `coeffs`). The texel-index row is always -1: an image texel of an
    outside winner is fetched here, not deferred."""
    n = rays.time.shape[0]
    emat = ext_mat_mode(scene)
    ext_box = _ext_types(scene)[2]
    if not accel and not ext_box:
        return _const_miss_rows(n, emat, rays.time.device)
    nan = float("nan")
    nan3 = V3(*(torch.where(alive, c, nan) for c in rays.ro))
    nand = V3(*(torch.where(alive, c, nan) for c in rays.rd))
    inf = torch.full_like(rays.time, INF)
    izero = torch.zeros_like(rays.inside)

    cf = coeffs or {}
    t_s, i_s = inf, izero
    sph_key = next((k for k in ix._SPHERE_SWEEPS if k in accel), None)
    if sph_key:
        t_s, i_s = flash.sphere_hit_d(sph_key, accel[sph_key], cf.get(sph_key), nan3, nand,
                                      rays.time, rays.inside, tmin, plain=plain)
    t_t, i_t = inf, izero
    tri_key = next((k for k in ("tri", "tri_cull") if k in accel), None)
    seed = None
    if tri_key == "tri_cull":
        # seeded with the sphere winner and the nearest rect (a t-only sweep
        # of the real rays), so that clusters behind either are pruned; the
        # step kernel finds the rect again. A dead lane's seed is 0. Where
        # the seed comes back no triangle was nearer: a miss here.
        seed = t_s
        if scene.n_rects:
            t_r, _ = ix._chunked_min(lambda s, c: ix.rect_ts(scene, rays, s, c, tmin, inf),
                                     scene.n_rects, n, rays.time.device)
            seed = torch.minimum(seed, t_r)
        seed = torch.where(alive, seed, 0.0)
    if tri_key:
        t_t, i_t = flash.tri_hit_d(tri_key, accel[tri_key], cf.get(tri_key), nan3, nand,
                                   rays.inside, tmin, seed, plain=plain)

    # a big box set: swept by tensor operations on the real rays (a NaN ray
    # would poison the minimum), dead lanes and misses masked afterwards
    t_b, i_b = inf, izero
    if ext_box:
        t_b, i_b = flash.box_hit_d(scene.box_lo, scene.box_hi, scene.box_cs, scene.box_off,
                                   scene.box_active, rays.ro, rays.rd, tmin)
        t_b = torch.where(alive & torch.isfinite(t_b), t_b, INF)

    # combine: on a tie sphere before triangle before box, as scene_hit
    # prefers them
    ext_t = torch.minimum(torch.minimum(t_s, t_t), t_b)
    is_s = t_s <= torch.minimum(t_t, t_b)
    is_t = ~is_s & (t_t <= t_b)
    is_b = ~is_s & ~is_t
    has = ext_t < INF
    safe_t = torch.where(has, ext_t, 1.0)
    one = torch.ones_like(safe_t)
    zero = torch.zeros_like(safe_t)
    nrm = V3(one, zero, zero)
    mat = izero
    uu = vv = zero
    records = []
    if sph_key:
        records.append((is_s, i_s, ix.sphere_record))
    if "tri" in accel or "tri_cull" in accel:
        records.append((is_t, i_t, ix.tri_record))
    if ext_box:
        records.append((is_b, i_b, ix.box_record))
    for mine, idx, record in records:
        _, n_w, u_w, v_w, m_w = record(scene, rays, safe_t, torch.where(mine & has, idx, 0))
        nrm = vwhere(mine, n_w, nrm)
        mat = torch.where(mine, m_w, mat)
        uu = torch.where(mine, u_w, uu)
        vv = torch.where(mine, v_w, vv)

    nx = torch.where(has, nrm.x, one)
    ny = torch.where(has, nrm.y, 0.0)
    nz = torch.where(has, nrm.z, 0.0)
    ext_t = torch.where(has, ext_t, INF)
    if not emat:
        return ext_t, nx, ny, nz, torch.where(has, mat, 0).to(torch.float32)
    midx = mat.long()
    mt, mp, mtex = scene.mat_type[midx], ix.gather(scene.mat_param, midx), scene.mat_tex[midx]
    p = rays.ro + rays.rd * safe_t
    # Perlin albedo through kernel B6 for the card's tensors, as the JAX
    # package's XLA path computes it in XLA; the differentiable candidate
    # keeps the tensor operations, whose gradient reaches p
    perlin = None
    if scene.has_perlin and coeffs is None:
        perlin = {"perlin": noise.noise_tables(scene) if ptab is None else ptab}
    albedo = textures.sample_texture(scene, mtex, uu, vv, p, ptab, accel=perlin, plain=plain)
    neg1 = zero - 1.0
    return (ext_t, nx, ny, nz, neg1, mt.to(torch.float32), mp,
            albedo.x, albedo.y, albedo.z, neg1)


# ---------------------------------------------------------------------------
# The step: plain PyTorch version and kernel wrapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """What one step needs beside the lane state: the packed scene
    (`pack_scene_hybrid`), the image atlas (u32 texels, (I, IH, IW)) and the
    render's constants."""

    meta: dict
    tables: tuple
    images: torch.Tensor
    width: int
    height: int
    sq: int
    max_bounces: int
    max_lum: float
    sample_lo: int
    n_samples: int


def hybrid_step_plain(cfg: StepConfig, fstate, istate, keys, rays_ct, pix, ext):
    """Plain PyTorch version of the step kernel, on any device: one
    `bounce.wave_step` on the (NF, N) f32 / (NI, N) i32 rows with the
    candidate rows `ext`. `keys` holds the u32 key bits in int32, `rays_ct`
    and `pix` are int32. Returns (fstate', istate', keys', rays_ct')."""
    tables = cfg.tables
    v3 = lambda r: V3(fstate[r], fstate[r + 1], fstate[r + 2])
    s = B.LaneState(
        accum=v3(R_ACC), ro=v3(R_RO), rd=v3(R_RD), time=fstate[R_TIME],
        beta=v3(R_BETA), radiance=v3(R_RAD), alive=fstate[R_ALIVE] > 0.0,
        count=istate[I_COUNT], inside=istate[I_INSIDE], depth=istate[I_DEPTH],
        keys=keys.to(torch.int64) & 0xFFFFFFFF, rays=rays_ct)
    texels = B.atlas_texels(cfg.images) if cfg.meta["image"] else None
    o = B.wave_step(cfg.meta, tables[:7], tables[8], tables[7], cfg.width,
                    cfg.height, cfg.sq, cfg.max_bounces, cfg.max_lum,
                    cfg.sample_lo, cfg.n_samples, pix.to(torch.int64), s,
                    ext=tuple(ext), texels=texels)
    f_out = torch.stack([*o.accum, *o.ro, *o.rd, o.time, *o.beta, *o.radiance,
                         o.alive.to(torch.float32)])
    i_out = torch.stack([o.count, o.inside, o.depth])
    k_out = torch.where(o.keys >= 2 ** 31, o.keys - 2 ** 32, o.keys).to(torch.int32)
    return f_out, i_out, k_out, o.rays


# the render kernels' parameter block, then ext_mat, image, n_img, ih, iw
_N_IPARAMS = B._N_IPARAMS + 5


def _check_lanes(dev, **lanes):
    """Each of `lanes` = (tensor, dtype, shape) is contiguous and on `dev`."""
    for name, (t, dtype, shape) in lanes.items():
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor of shape {shape} "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_scene_tables(dev, tables, images):
    for t in tables:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"scene tables must be contiguous float32 on {dev}")
    if tables[8].shape != (6, 256) or tables[7].shape != (21,):
        raise ValueError("bad Perlin or camera table shape")
    if (images.device != dev or images.dtype != torch.uint32
            or images.dim() != 3 or not images.is_contiguous()):
        raise ValueError(f"images must be a contiguous uint32 (I, IH, IW) "
                         f"tensor on {dev}")
    if images.numel() >= 2 ** 31:
        raise ValueError("too many texels for int32 indexing")


def hybrid_step(cfg: StepConfig, fstate, istate, keys, rays_ct, pix, ext):
    """One hybrid wave step on the state's device: the CUDA kernel for CUDA
    tensors, `hybrid_step_plain` for CPU tensors. Arguments and results as
    `hybrid_step_plain`; nothing is updated in place."""
    if device.kind(fstate, "hybrid step") == "cpu":
        return hybrid_step_plain(cfg, fstate, istate, keys, rays_ct, pix, ext)
    from miniraytracer_tpu_torch.utils import kernels

    global step_launches
    meta, tables, images = cfg.meta, cfg.tables, cfg.images
    dev, n = fstate.device, fstate.shape[1]
    ne = NE_MAT if meta.get("ext_mat") else NE
    _check_lanes(dev, fstate=(fstate, torch.float32, (NF, n)),
                 istate=(istate, torch.int32, (NI, n)), keys=(keys, torch.int32, (n,)),
                 rays_ct=(rays_ct, torch.int32, (n,)), pix=(pix, torch.int32, (n,)),
                 ext=(ext, torch.float32, (ne, n)))
    _check_scene_tables(dev, tables, images)
    if NF * n >= 2 ** 31 - 128:
        raise ValueError("too many lanes for int32 indexing")
    ip = B.kernel_params(meta, n, cfg.sample_lo, cfg.n_samples,
                         width=cfg.width, height=cfg.height,
                         max_bounces=cfg.max_bounces, spp_sq=cfg.sq)
    ip += [int(bool(meta.get("ext_mat"))), int(meta["image"]), *images.shape]
    outs = [torch.empty_like(t) for t in (fstate, istate, keys, rays_ct)]
    lib = kernels.load("hybrid")
    fn = lib.mrt_hybrid_step
    fn.argtypes = ([ctypes.c_void_p] * 20
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptrs = [*tables, images, fstate, istate, keys, rays_ct, pix, ext, *outs]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in ptrs],
                (ctypes.c_int * _N_IPARAMS)(*ip), ctypes.c_float(cfg.max_lum),
                stream)
    if rc != 0:
        raise RuntimeError(f"mrt_hybrid_step failed: {kernels.error_string(lib, rc)}")
    step_launches += 1
    return tuple(outs)


# ---------------------------------------------------------------------------
# The work queue's shade step: plain PyTorch version and kernel wrapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShadeConfig:
    """The packed scene (`pack_scene_hybrid`) and the image atlas (u32
    texels, (I, IH, IW)): what a shade step needs beside the lanes."""

    meta: dict
    tables: tuple
    images: torch.Tensor


def shade_step_plain(cfg: ShadeConfig, fstate, inside, keys_b, ext):
    """Plain PyTorch version of the shade kernel, on any device: one
    `bounce.shade_advance` with the candidate rows `ext`. `fstate` is the
    (SH_NF, N) f32 input rows, `inside` (N,) int32, `keys_b` the depth-folded
    u32 key bits in int32. Returns ((SO_NF, N) f32 output rows, new_inside (N,) int32); p, new_rd
    and new_inside are zero where cont is 0."""
    meta, tables = cfg.meta, cfg.tables
    v3 = lambda r: V3(fstate[r], fstate[r + 1], fstate[r + 2])
    texels = B.atlas_texels(cfg.images) if meta["image"] else None
    b, cont, beta, radiance = B.shade_advance(
        meta, tables[:7], tables[8], v3(SH_RO), v3(SH_RD), fstate[SH_TIME], inside,
        keys_b.to(torch.int64) & 0xFFFFFFFF, fstate[SH_DOK] > 0.0, fstate[SH_ALIVE] > 0.0,
        v3(SH_BETA), v3(SH_RAD), ext=tuple(ext), texels=texels)
    zero = torch.zeros_like(b.safe_t)
    zero3 = V3(zero, zero, zero)
    f_out = torch.stack([cont.to(torch.float32), *vwhere(cont, b.p, zero3),
                         *vwhere(cont, b.new_rd, zero3), *beta, *radiance])
    return f_out, torch.where(cont, b.new_inside, 0)


def shade_step(cfg: ShadeConfig, fstate, inside, keys_b, ext):
    """One shade step on the lanes' device: the CUDA kernel for CUDA tensors,
    `shade_step_plain` for CPU tensors. Arguments and results as
    `shade_step_plain`; nothing is updated in place."""
    if device.kind(fstate, "shade step") == "cpu":
        return shade_step_plain(cfg, fstate, inside, keys_b, ext)
    from miniraytracer_tpu_torch.utils import kernels

    global shade_launches
    meta, tables, images = cfg.meta, cfg.tables, cfg.images
    dev, n = fstate.device, fstate.shape[1]
    ne = NE_MAT if meta.get("ext_mat") else NE
    _check_lanes(dev, fstate=(fstate, torch.float32, (SH_NF, n)),
                 inside=(inside, torch.int32, (n,)), keys_b=(keys_b, torch.int32, (n,)),
                 ext=(ext, torch.float32, (ne, n)))
    _check_scene_tables(dev, tables, images)
    if SH_NF * n >= 2 ** 31 - 128:
        raise ValueError("too many lanes for int32 indexing")
    ip = B.kernel_params(meta, n, 0, 0, width=1, height=1, max_bounces=0, spp_sq=1)
    ip += [int(bool(meta.get("ext_mat"))), int(meta["image"]), *images.shape]
    f_out = torch.empty((SO_NF, n), dtype=torch.float32, device=dev)
    i_out = torch.empty_like(inside)
    lib = kernels.load("hybrid")
    fn = lib.mrt_shade_step
    fn.argtypes = ([ctypes.c_void_p] * 16
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptrs = [*tables, images, fstate, inside, keys_b, ext, f_out, i_out]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in ptrs], (ctypes.c_int * _N_IPARAMS)(*ip), stream)
    if rc != 0:
        raise RuntimeError(f"mrt_shade_step failed: {kernels.error_string(lib, rc)}")
    shade_launches += 1
    return f_out, i_out


def make_workqueue_shader(scene: T.SceneData, plain=False):
    """The work queue's shading phase on the scene's device:

        shader(rays, keys_b, depth_ok, alive, beta, radiance)
          -> (p V3, new_rd V3, new_inside, cont, beta' V3, radiance' V3)

    with `keys_b` the depth-folded u32 keys (in int64, as `ops/rng.py` holds
    them). The sweeps of `ops/flash.py` intersect the external types, the
    shade step does the in-table sweep and the shading: kernels on a CUDA
    scene, their plain versions on a CPU scene or with `plain`."""
    if not can_hybrid(scene):
        raise ValueError(f"scene {scene.name!r} is outside the hybrid class "
                         "(see can_hybrid)")
    meta, tables = pack_scene_hybrid(scene)
    cfg = ShadeConfig(meta=meta, tables=tuple(tables), images=scene.images)
    accel = hybrid_accel(scene)
    ptab = noise.noise_tables(scene) if scene.has_perlin else None
    step = shade_step_plain if plain else shade_step

    def shader(rays: ix.Rays, keys_b, depth_ok, alive, beta: V3, radiance: V3):
        ext = torch.stack(_external_candidate(scene, accel, rays, alive, B.TMIN,
                                              ptab, plain))
        fstate = torch.stack([*rays.ro, *rays.rd, rays.time, *beta, *radiance,
                              depth_ok.to(torch.float32), alive.to(torch.float32)])
        kb = torch.where(keys_b >= 2 ** 31, keys_b - 2 ** 32, keys_b).to(torch.int32)
        f, new_inside = step(cfg, fstate, rays.inside, kb, ext)
        v3 = lambda r: V3(f[r], f[r + 1], f[r + 2])
        return (v3(SO_P), v3(SO_RD), new_inside, f[SO_CONT] > 0.0, v3(SO_BETA),
                v3(SO_RAD))

    return shader


# ---------------------------------------------------------------------------
# The render loop
# ---------------------------------------------------------------------------


def initial_state(scene, pix, sample_lo, n_samples, *, width, height, spp_sq):
    """Lane state at the first camera ray of sample `sample_lo` of each pixel
    in `pix` ((N,) int32): (fstate, istate, keys, rays_ct)."""
    n, dev = pix.shape[0], pix.device
    pix64 = pix.to(torch.int64)
    samp0 = torch.full((n,), sample_lo, dtype=torch.int64, device=dev)
    keys0 = rng.ray_key(pix64, samp0)
    ss, tt = B.film_coords(pix64, samp0, width, height, spp_sq)
    rays0 = cam_mod.get_rays(scene.camera, ss, tt, keys0)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    one = zero + 1.0
    alive0 = zero + (1.0 if n_samples > 0 else 0.0)
    fstate = torch.stack([zero, zero, zero, *rays0.ro, *rays0.rd, rays0.time,
                          one, one, one, zero, zero, zero, alive0])
    izero = torch.zeros((n,), dtype=torch.int32, device=dev)
    istate = torch.stack([izero, rays0.inside, izero])
    keys = torch.where(keys0 >= 2 ** 31, keys0 - 2 ** 32, keys0).to(torch.int32)
    return fstate, istate, keys, izero.clone()


def state_rays(fstate, istate) -> ix.Rays:
    """The lanes' current rays, as views of the state rows."""
    return ix.Rays(ro=V3(*fstate[R_RO:R_RO + 3]), rd=V3(*fstate[R_RD:R_RD + 3]),
                   time=fstate[R_TIME], inside=istate[I_INSIDE])


def _render_args(scene, pix, width, height, spp_sq, max_bounces):
    B.check_render_args(scene, pix, width, height, spp_sq, max_bounces)
    if not can_hybrid(scene):
        raise ValueError(f"scene {scene.name!r} is outside the hybrid class "
                         "(see can_hybrid)")


def render_wavefront_hybrid_pixels(scene, pix, sample_lo, n_samples, max_lum,
                                   *, width, height, max_bounces, spp_sq,
                                   plain=False, stats=None):
    """The hybrid render of samples [sample_lo, sample_lo + n_samples) of
    each pixel in `pix` ((N,) int32, index x + y*width), on the scene's
    device: the kernels for a CUDA scene, their plain versions for a CPU
    scene or with `plain`. Returns (accum (N,3) = running average * count,
    count (N,) i32, rays (N,) i32). `stats`, a dict, receives the number of
    wave steps under "steps"."""
    _render_args(scene, pix, width, height, spp_sq, max_bounces)
    meta, tables = pack_scene_hybrid(scene)
    accel = hybrid_accel(scene)
    cfg = StepConfig(meta=meta, tables=tuple(tables), images=scene.images,
                     width=width, height=height, sq=spp_sq,
                     max_bounces=max_bounces, max_lum=float(max_lum),
                     sample_lo=int(sample_lo), n_samples=int(n_samples))
    ptab = noise.noise_tables(scene) if scene.has_perlin else None
    step = hybrid_step_plain if plain else hybrid_step
    fstate, istate, keys, rays_ct = initial_state(
        scene, pix, sample_lo, n_samples, width=width, height=height,
        spp_sq=spp_sq)
    steps = 0
    while bool((fstate[R_ALIVE] > 0.0).any()):
        er = _external_candidate(scene, accel, state_rays(fstate, istate),
                                 fstate[R_ALIVE] > 0.0, B.TMIN, ptab, plain)
        fstate, istate, keys, rays_ct = step(
            cfg, fstate, istate, keys, rays_ct, pix, torch.stack(er))
        steps += 1
    if stats is not None:
        stats["steps"] = steps
    return fstate[R_ACC:R_ACC + 3].t().contiguous(), istate[I_COUNT], rays_ct


def render_wavefront_hybrid(scene, width, height, spp, max_bounces=32,
                            max_lum=1000.0):
    """Full-frame hybrid render on the scene's device. Returns (frame (H,W,3)
    f32 tensor, stats); stats["rays"] is the exact int ray count and
    stats["steps"] the number of wave steps."""
    sq = int(math.isqrt(spp))
    ns = sq * sq
    t0 = _time.perf_counter()
    pix = torch.arange(width * height, dtype=torch.int32, device=scene.device)
    stats = {}
    accum, count, rays = render_wavefront_hybrid_pixels(
        scene, pix, 0, ns, max_lum, width=width, height=height,
        max_bounces=max_bounces, spp_sq=sq, stats=stats)
    frame = accum / torch.clamp_min(count.to(torch.float32), 1.0)[:, None]
    total = int(rays.sum(dtype=torch.int64))  # waits for the device
    elapsed = _time.perf_counter() - t0
    return frame.reshape(height, width, 3), {
        "seconds": elapsed,
        "rays": total,
        "mrays_per_s": total / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": ns,
        "steps": stats["steps"],
        "renderer": "hybrid",
    }
