"""Differentiable fused bounce: the train step's scan, one kernel pair per step.

Port of `miniraytracer_tpu/ops/bounce_ad.py`. One lane is one PIXEL tracing
`spp` samples one after the other, so a lane's output is (finite-radiance
sum, valid count), which is what the SSE loss consumes. One scan step is

- forward: kernel `mrt_ad_step_fwd` (`csrc/bounce_ad.cu`): `k_sub` sub-steps
  of bounce + completion merge + claim-gated regeneration on (rows, N) lane
  state;
- backward: kernel `mrt_ad_step_bwd`: replays the sub-steps from the saved
  entry state (the counter-based RNG makes the replay exact) and applies the
  adjoint of the step, derived by hand, giving the cotangent of the carried
  lane state and of the differentiable scene-table entries (`diff_indices`:
  sphere centres and radii, triangle base vertices, material parameters,
  texture colours), summed over lanes.

Each kernel has a plain PyTorch version: `_pixel_step_math` (built from
`bounce.bounce_physics`) and `ad_step_bwd_plain` (`torch.autograd.grad`
through a replay of the plain step). The wrappers `ad_step_fwd` /
`ad_step_bwd` launch the kernel for CUDA tensors and run the plain version
for CPU tensors. `FusedADScan` ties the scan into autograd:
`sample_pixel_sums_fused` is differentiable w.r.t. the scene's `TrainParams`
leaves (`parallel/train.py`) through `bounce.pack_scene`.

Scenes outside the fused class take the hybrid-ext step (`use_ext=True`,
the JAX package's `fused_ad="ext"`): the big sphere, triangle and box sets
stay out of the kernels' tables (`hybrid.pack_scene_hybrid`) and each scan
step first finds, outside the kernel, the nearest hit over them and its
record (`ExtCandidate`: `hybrid._external_candidate` over the differentiable
sweeps of `ops/flash.py`), which the step takes as an input: its candidate
rows `ext`. The backward kernel gives their cotangent `d_ext`, which a replay
of the candidate under autograd pushes back to the rays (into the carried
state's cotangent) and to the sweeps' coefficient tables and the scene's
leaves. Image textures (earth, book2_final) are fetched in the kernel and
multiplied into the throughput of a lane that goes on. These modes take one
sub-step a launch; `FusedADScan` takes the candidate as an input.

Lane state: `fstate` (NF, N) f32 rows (A_* offsets), `istate` (NJ, N) i32
rows (J_*), `keys` (N,) i32 holding the u32 path key's bits. Everything
discrete (comparisons, type selects, RNG, camera rays) is piecewise constant
and carries no cotangent.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import NamedTuple

import torch

from miniraytracer_tpu_torch.models import camera as cam_mod
from miniraytracer_tpu_torch.ops import bounce as B
from miniraytracer_tpu_torch.ops import hybrid, noise, rng
from miniraytracer_tpu_torch.ops import intersect as ix
from miniraytracer_tpu_torch.ops.vecmath import V3, vdiv, vwhere
from miniraytracer_tpu_torch.scene import types as T
from miniraytracer_tpu_torch.utils import device

# float state rows
A_SUM, A_RO, A_RD, A_TIME, A_BETA, A_RAD, A_ALIVE, A_NV, A_RAYS = (
    0, 3, 6, 9, 10, 13, 16, 17, 18)
NF = 19
# int state rows
J_COUNT, J_INSIDE, J_DEPTH = 0, 1, 2
NJ = 3
# residual float rows: fstate[A_RO : A_ALIVE+1] (ro rd time beta rad alive)
RES_LO, RES_HI = A_RO, A_ALIVE + 1

MAX_SUB_STEPS = 8  # csrc/bounce_ad.cu: MAX_KSUB

# Launch counts of the two CUDA kernels (never the plain versions), in all,
# and by direction and mode: {("fwd" or "bwd", `step_mode`): launches}.
fwd_launches = 0
bwd_launches = 0
mode_launches = collections.Counter()


class StepConfig(NamedTuple):
    """Static configuration of one scan step."""

    width: int
    height: int
    sq_off: int
    max_bounces: int
    spp: int
    claim_limit: int
    k_sub: int


def table_lengths(meta):
    S, R, Tc, V = meta["S"], meta["R"], meta["Tc"], meta["V"]
    Bx = meta["Bx"]
    M, X = meta["M"], meta["X"]
    return dict(
        sph=12 * S if S else 1,
        rect=17 * R if R else 1,
        tri=20 * Tc if Tc else 1,
        box=13 * Bx if Bx else 1,
        vol=16 * V if V else 1,
        mat=3 * M,
        tex=9 * X,
        cam=21,
    )


def diff_indices(meta):
    """Per-table entry indices that receive cotangents: exactly the
    TrainParams set (parallel/train.py): sph_c0, sph_radius, tri_m,
    mat_param, tex_c0, tex_c1. The flat cotangent `d_tab` lists them in the
    order sph, tri, mat, tex."""
    S, Tc, M, X = meta["S"], meta["Tc"], meta["M"], meta["X"]
    return dict(
        sph=list(range(0, 3 * S)) + list(range(9 * S, 10 * S)),
        tri=list(range(0, 3 * Tc)),
        mat=list(range(M, 2 * M)),
        tex=list(range(X, 7 * X)),
    )


# tables[k] of pack_scene for each diff_indices key, in d_tab order
_DIFF_TABLES = (("sph", 0), ("tri", 2), ("mat", 5), ("tex", 6))


def n_diff(meta) -> int:
    return sum(len(v) for v in diff_indices(meta).values())


def _check_meta(meta, ext=False):
    if not ext and (meta["image"] or meta.get("ext_mat")):
        raise ValueError("the fused AD step has no image textures and no "
                         "ext-material mode: those need the candidate from outside")
    if len(meta["lights"]) > B.MAX_LIGHTS:
        raise ValueError(f"at most {B.MAX_LIGHTS} lights")


def _keys_u32(keys):
    """i32 key bits -> the u32 value in int64 (ops/rng.py's form)."""
    return keys.to(torch.int64) & 0xFFFFFFFF


def _keys_i32(k64):
    return torch.where(k64 >= 2 ** 31, k64 - 2 ** 32, k64).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain PyTorch step (the forward kernel's plain version, and the function the
# plain backward differentiates)
# ---------------------------------------------------------------------------


def _pixel_step_math(meta, cfg: StepConfig, tabs, camv, ptab, pix, sampbase,
                     t_step, f, i, keys, ext=None, texels=None):
    """One scan sub-step on (N,) lanes: bounce + completion merge + regen.

    `f` is a sequence of NF float rows, `i` of NJ int32 rows, `keys`, `pix`
    and `sampbase` are int64 (u32 values for keys). `ext`, the candidate
    rows from outside (`bounce.bounce_physics`); with meta["image"],
    `texels` is the image atlas (`bounce.atlas_texels`) and a lane that goes
    on multiplies its texel into its throughput. Returns (f' tuple, i'
    tuple, keys')."""
    n_off = cfg.sq_off * cfg.sq_off
    summ = V3(f[A_SUM], f[A_SUM + 1], f[A_SUM + 2])
    ro = V3(f[A_RO], f[A_RO + 1], f[A_RO + 2])
    rd = V3(f[A_RD], f[A_RD + 1], f[A_RD + 2])
    time = f[A_TIME]
    beta = V3(f[A_BETA], f[A_BETA + 1], f[A_BETA + 2])
    radiance = V3(f[A_RAD], f[A_RAD + 1], f[A_RAD + 2])
    alive = f[A_ALIVE] > 0.0
    nvalid = f[A_NV]
    rays_ct = f[A_RAYS] + alive.to(torch.float32)
    count, inside, depth = i[J_COUNT], i[J_INSIDE], i[J_DEPTH]

    keys_b = rng.fold(keys, depth)
    depth_ok = depth < cfg.max_bounces

    b = B.bounce_physics(meta, tabs, ptab, ro, rd, time, inside, keys_b, ext=ext)
    scattered = depth_ok & ~b.is_light
    add_emitted = ~(scattered & b.is_specular)
    zero = torch.zeros_like(b.safe_t)
    zero3 = V3(zero, zero, zero)
    ones3 = V3(zero + 1.0, zero + 1.0, zero + 1.0)

    miss = alive & ~b.hit
    bg = B.background_color(meta["use_sky"], rd)
    radiance = radiance + vwhere(miss, beta * bg, zero3)
    emit_mask = alive & b.hit & add_emitted
    radiance = radiance + vwhere(emit_mask, beta * b.emitted, zero3)
    cont = alive & b.hit & scattered
    beta = vwhere(cont, beta * b.weight, beta)
    cont = cont & ((beta.x > 0.0) | (beta.y > 0.0) | (beta.z > 0.0))
    if b.img_id is not None:
        beta = B.pending_texel(b.img_id, cont, beta, texels)

    # completion: fold the finished sample into (sum, nvalid) under the
    # all-channel finite mask (the loss's done & isfinite, the render NaN rule)
    finished = alive & ~cont
    finite = (torch.isfinite(radiance.x) & torch.isfinite(radiance.y)
              & torch.isfinite(radiance.z))
    take = finished & finite
    summ = summ + vwhere(take, radiance, zero3)
    nvalid = nvalid + take.to(torch.float32)
    count = torch.where(finished, count + 1, count)

    # regeneration: claim the lane's next sample while the claim window is
    # open (a started sample always finishes within the scan)
    regen = finished & (count < cfg.spp) & bool(t_step < cfg.claim_limit)
    samp = sampbase + count
    new_keys = rng.ray_key(pix, samp)
    ci = samp % n_off
    off_x = vdiv(torch.div(ci, cfg.sq_off, rounding_mode="floor").to(torch.float32) + 0.5,
                 cfg.sq_off)
    off_y = vdiv((ci % cfg.sq_off).to(torch.float32) + 0.5, cfg.sq_off)
    xpix = (pix % cfg.width).to(torch.float32)
    ypix = torch.div(pix, cfg.width, rounding_mode="floor").to(torch.float32)
    ss = vdiv(xpix + off_x, cfg.width)
    tt = vdiv(ypix + off_y, cfg.height)
    new_ro, new_rd, new_time = B.camera_ray(camv, ss, tt, new_keys)

    out_ro = vwhere(regen, new_ro, vwhere(cont, b.p, ro))
    out_rd = vwhere(regen, new_rd, vwhere(cont, b.new_rd, rd))
    out_time = torch.where(regen, new_time, time)
    out_inside = torch.where(regen, 0, torch.where(cont, b.new_inside, inside))
    out_beta = vwhere(regen, ones3, beta)
    out_rad = vwhere(regen, zero3, radiance)
    out_depth = torch.where(regen, 0, depth + 1)
    out_alive = (cont | regen).to(torch.float32)
    out_keys = torch.where(regen, new_keys, keys)

    f_out = (summ.x, summ.y, summ.z, out_ro.x, out_ro.y, out_ro.z,
             out_rd.x, out_rd.y, out_rd.z, out_time,
             out_beta.x, out_beta.y, out_beta.z,
             out_rad.x, out_rad.y, out_rad.z, out_alive, nvalid, rays_ct)
    return f_out, (count, out_inside, out_depth), out_keys


def _plain_substeps(meta, cfg, tables, t_step, f, i, k64, pix64, sb64, ext=None,
                    images=None):
    """`cfg.k_sub` sub-steps of the plain step; global step index
    `t_step * k_sub + j`, so claim gating is in global units."""
    tabs, camv, ptab = tables[:7], tables[7], tables[8]
    ext = None if ext is None else tuple(ext)
    texels = B.atlas_texels(images) if meta["image"] else None
    for j in range(cfg.k_sub):
        f, i, k64 = _pixel_step_math(meta, cfg, tabs, camv, ptab, pix64, sb64,
                                     t_step * cfg.k_sub + j, f, i, k64, ext, texels)
    return f, i, k64


def ad_step_fwd_plain(meta, cfg, tables, t_step, fstate, istate, keys, pix, sb, ext=None,
                      images=None):
    """Plain PyTorch version of `mrt_ad_step_fwd`, on any device. `ext` is
    the (NE, N) candidate from outside (None in the fused class), `images`
    the scene's image atlas (with meta["image"])."""
    with torch.no_grad():
        f, i, k64 = _plain_substeps(
            meta, cfg, tables, t_step, tuple(fstate), tuple(istate),
            _keys_u32(keys), pix.to(torch.int64), sb.to(torch.int64), ext, images)
        return torch.stack(f), torch.stack(i), _keys_i32(k64)


def ad_step_bwd_plain(meta, cfg, tables, t_step, f_res, istate, keys, pix, sb,
                      cot_f, ext=None, images=None):
    """Plain PyTorch version of `mrt_ad_step_bwd`: autograd through a replay
    of the plain step from the saved entry state. `f_res` is the residual
    (RES_HI - RES_LO, N) block of the entry `fstate`; the sum, nvalid and
    rays rows enter the step additively, so zeros stand in for them. Returns
    (d_f (NF, N), d_tab (n_diff,)), and d_ext (NE, N) after them when the
    candidate `ext` is given."""
    didx = diff_indices(meta)
    with torch.enable_grad():
        tabs = [t.detach() for t in tables]
        for _, k in _DIFF_TABLES:
            tabs[k] = tabs[k].clone().requires_grad_(True)
        n = f_res.shape[1]
        zeros = f_res.new_zeros((3, n))
        f_in = torch.cat([zeros, f_res.detach(), zeros[:2]]).requires_grad_(True)
        ext_in = None if ext is None else ext.detach().clone().requires_grad_(True)
        f_out, _, _ = _plain_substeps(
            meta, cfg, tabs, t_step, tuple(f_in), tuple(istate),
            _keys_u32(keys), pix.to(torch.int64), sb.to(torch.int64), ext_in, images)
        leaves = [f_in] + [tabs[k] for _, k in _DIFF_TABLES]
        if ext_in is not None:
            leaves.append(ext_in)
        grads = torch.autograd.grad(torch.stack(f_out), leaves,
                                    grad_outputs=cot_f, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    parts = []
    for (name, k), g in zip(_DIFF_TABLES, grads[1:]):
        idx = torch.as_tensor(didx[name], dtype=torch.int64, device=f_res.device)
        parts.append(g[idx])
    if ext is None:
        return grads[0], torch.cat(parts)
    return grads[0], torch.cat(parts), grads[-1]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# integer parameter block of the AD kernels (csrc/bounce_ad.cu: AdParamIdx)
_N_IPARAMS = 28
# and their ext-mode block (AdExtIdx): ext, ext_mat, image, n_img, ih, iw
_N_XPARAMS = 6


def kernel_params(meta, cfg: StepConfig, n, t_step, ext=False):
    """The integer parameter block of `mrt_ad_step_fwd` / `mrt_ad_step_bwd`
    (csrc/bounce_ad.cu, AdParamIdx order)."""
    _check_meta(meta, ext)
    lights = list(meta["lights"])
    if NF * n >= 2 ** 31 - 128 or cfg.width * cfg.height >= 2 ** 31:
        raise ValueError("too many lanes for the kernels' int32 indexing of "
                         f"({NF}, N) rows")
    if not 1 <= cfg.k_sub <= MAX_SUB_STEPS:
        raise ValueError(f"sub_steps must be in 1..{MAX_SUB_STEPS}")
    if ext and cfg.k_sub != 1:
        raise ValueError("the step with a candidate from outside takes one sub-step a launch")
    pad = [0] * (B.MAX_LIGHTS - len(lights))
    ip = [n, cfg.width, cfg.height, cfg.sq_off, cfg.max_bounces, cfg.spp,
          cfg.claim_limit, cfg.k_sub, t_step,
          meta["S"], meta["R"], meta["Tc"], meta["Bx"], meta["V"], meta["M"],
          meta["X"], len(lights), *[lt for lt, _ in lights], *pad,
          *[li for _, li in lights], *pad, int(meta["use_sky"]),
          int(meta["exact_cosine"]), int(meta["perlin"])]
    assert len(ip) == _N_IPARAMS
    return ip


def ext_rows(meta) -> int:
    """Rows of the candidate a step of this meta takes: NE, or NE_MAT in
    ext-material mode."""
    return hybrid.NE_MAT if meta.get("ext_mat") else hybrid.NE


def step_mode(meta, ext: bool) -> str:
    """The kernels' instance a step runs: "fused" (no candidate), "ext",
    "ext_mat", "image" (ext with image textures) or "ext_mat_image"."""
    if not ext:
        return "fused"
    if meta["image"]:
        return "ext_mat_image" if meta.get("ext_mat") else "image"
    return "ext_mat" if meta.get("ext_mat") else "ext"


def ext_params(meta, ext: bool, images=None):
    """The ext-mode block (csrc/bounce_ad.cu, AdExtIdx order): the three
    switches and, with image textures, the atlas's shape."""
    image = bool(meta["image"])
    return [int(ext), int(bool(meta.get("ext_mat"))), int(image),
            *(tuple(images.shape) if image else (0, 0, 0))]


def _check_lanes(dev, n, **tensors):
    for name, (t, dtype, rows) in tensors.items():
        shape = (n,) if rows is None else (rows, n)
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor of shape "
                f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_tables(dev, meta, tables):
    lens = table_lengths(meta)
    names = ("sph", "rect", "tri", "box", "vol", "mat", "tex", "cam")
    for name, t in zip(names, tables):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (lens[name],) or not t.is_contiguous()):
            raise ValueError(f"table {name} must be a contiguous float32 "
                             f"vector of {lens[name]} on {dev}")
    if tables[8].device != dev or tables[8].shape != (6, 256):
        raise ValueError("bad Perlin table")


def _ext_args(meta, dev, n, ext, images):
    """(ext pointer, texels pointer, ext-mode block) of a launch, checked."""
    if ext is not None:
        _check_lanes(dev, n, ext=(ext, torch.float32, ext_rows(meta)))
    elif meta["image"] or meta.get("ext_mat"):
        raise ValueError("this step needs its candidate rows `ext`")
    if meta["image"]:
        if (images is None or images.device != dev or images.dtype != torch.uint32
                or images.dim() != 3 or not images.is_contiguous()
                or images.numel() >= 2 ** 31):
            raise ValueError(f"images must be a contiguous uint32 (I, IH, IW) tensor on {dev}")
    xp = ext_params(meta, ext is not None, images)
    return (None if ext is None else ext.data_ptr(),
            images.data_ptr() if meta["image"] else None, xp)


def ad_step_fwd(meta, cfg, tables, t_step, fstate, istate, keys, pix, sb, ext=None,
                images=None):
    """One scan step (`cfg.k_sub` sub-steps) on the state's device: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. `ext` and
    `images` as in `ad_step_fwd_plain`. Returns (fstate', istate', keys')."""
    if device.kind(fstate, "fused AD step") == "cpu":
        return ad_step_fwd_plain(meta, cfg, tables, t_step, fstate, istate,
                                 keys, pix, sb, ext, images)
    from miniraytracer_tpu_torch.utils import kernels

    global fwd_launches
    dev, n = fstate.device, fstate.shape[1]
    tables = [t.detach() for t in tables]
    _check_tables(dev, meta, tables)
    _check_lanes(dev, n, fstate=(fstate, torch.float32, NF),
                 istate=(istate, torch.int32, NJ),
                 keys=(keys, torch.int32, None), pix=(pix, torch.int32, None),
                 sb=(sb, torch.int32, None))
    ip = kernel_params(meta, cfg, n, t_step, ext is not None)
    ext_p, tex_p, xp = _ext_args(meta, dev, n, ext, images)
    f_out, i_out, k_out = (torch.empty_like(fstate), torch.empty_like(istate),
                           torch.empty_like(keys))
    lib = kernels.load("bounce_ad")
    fn = lib.mrt_ad_step_fwd
    fn.argtypes = ([ctypes.c_void_p] * 19
                   + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in tables], fstate.data_ptr(),
                istate.data_ptr(), keys.data_ptr(), pix.data_ptr(),
                sb.data_ptr(), ext_p, tex_p, f_out.data_ptr(), i_out.data_ptr(),
                k_out.data_ptr(), (ctypes.c_int * _N_IPARAMS)(*ip),
                (ctypes.c_int * _N_XPARAMS)(*xp), stream)
    if rc != 0:
        raise RuntimeError(
            f"mrt_ad_step_fwd failed: {kernels.error_string(lib, rc)}")
    fwd_launches += 1
    mode_launches["fwd", step_mode(meta, ext is not None)] += 1
    return f_out, i_out, k_out


def ad_step_bwd(meta, cfg, tables, t_step, f_res, istate, keys, pix, sb, cot_f,
                d_tab=None, ext=None, images=None):
    """Backward of one scan step from its saved entry state: the CUDA kernel
    for CUDA tensors, `ad_step_bwd_plain` for CPU tensors. Returns (d_f (NF,
    N), d_tab (n_diff,)), and d_ext (NE, N) after them when the candidate
    `ext` is given. `d_tab`, when given, is a float32 accumulator that the
    table cotangents are ADDED to (and returned). The kernel sums lanes with
    floating-point atomics, so `d_tab` varies from run to run by about 1e-6
    relative; `d_ext` is written lane by lane."""
    if device.kind(f_res, "fused AD step") == "cpu":
        out = ad_step_bwd_plain(meta, cfg, tables, t_step, f_res, istate, keys, pix,
                                sb, cot_f, ext, images)
        d_new = out[1]
        return (out[0], d_new if d_tab is None else d_tab.add_(d_new), *out[2:])
    from miniraytracer_tpu_torch.utils import kernels

    global bwd_launches
    dev, n = f_res.device, f_res.shape[1]
    tables = [t.detach() for t in tables]
    nd = n_diff(meta)
    _check_tables(dev, meta, tables)
    if d_tab is None:
        d_tab = torch.zeros((nd,), dtype=torch.float32, device=dev)
    _check_lanes(dev, n, f_res=(f_res, torch.float32, RES_HI - RES_LO),
                 istate=(istate, torch.int32, NJ),
                 keys=(keys, torch.int32, None), pix=(pix, torch.int32, None),
                 sb=(sb, torch.int32, None), cot_f=(cot_f, torch.float32, NF))
    if (d_tab.device != dev or d_tab.dtype != torch.float32
            or tuple(d_tab.shape) != (nd,) or not d_tab.is_contiguous()):
        raise ValueError(f"d_tab must be a float32 vector of {nd} on {dev}")
    ip = kernel_params(meta, cfg, n, t_step, ext is not None)
    ext_p, tex_p, xp = _ext_args(meta, dev, n, ext, images)
    d_f = torch.empty_like(cot_f)
    d_ext = None if ext is None else torch.empty_like(ext)
    lib = kernels.load("bounce_ad")
    fn = lib.mrt_ad_step_bwd
    fn.argtypes = ([ctypes.c_void_p] * 20
                   + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in tables], f_res.data_ptr(),
                istate.data_ptr(), keys.data_ptr(), pix.data_ptr(),
                sb.data_ptr(), ext_p, tex_p, cot_f.data_ptr(), d_f.data_ptr(),
                None if d_ext is None else d_ext.data_ptr(), d_tab.data_ptr(),
                (ctypes.c_int * _N_IPARAMS)(*ip), (ctypes.c_int * _N_XPARAMS)(*xp), stream)
    if rc != 0:
        raise RuntimeError(
            f"mrt_ad_step_bwd failed: {kernels.error_string(lib, rc)}")
    bwd_launches += 1
    mode_launches["bwd", step_mode(meta, ext is not None)] += 1
    if d_ext is None:
        return d_f, d_tab
    return d_f, d_tab, d_ext


# ---------------------------------------------------------------------------
# The scan as one autograd function
# ---------------------------------------------------------------------------


def scan_forward(meta, cfg, outer_steps, tables, f0, i0, k0, pix, sb, *,
                 plain=False, keep=True, candidate=None, images=None):
    """Run `outer_steps` scan steps from the state (f0, i0, k0). With `keep`,
    also returns each launch's entry state, the residual of the backward
    pass: (res_f (steps, 14, N), res_i (steps, 3, N), res_k (steps, N)),
    18 words per lane and launch. With `candidate` (an `ExtCandidate`) each
    step first takes its candidate rows from its entry state, and the
    residual keeps them too: res_e (steps, NE, N) after the other three.
    `images` is the scene's image atlas for a step with image textures.
    Returns ((f, i, k), residual or None)."""
    step_fwd = ad_step_fwd_plain if plain else ad_step_fwd
    n, dev = f0.shape[1], f0.device
    residual = None
    if keep:
        residual = (
            torch.empty((outer_steps, RES_HI - RES_LO, n), dtype=torch.float32,
                        device=dev),
            torch.empty((outer_steps, NJ, n), dtype=torch.int32, device=dev),
            torch.empty((outer_steps, n), dtype=torch.int32, device=dev))
        if candidate is not None:
            residual += (torch.empty((outer_steps, ext_rows(meta), n), dtype=torch.float32,
                                     device=dev),)
    f, i, k = f0, i0, k0
    for t in range(outer_steps):
        ext = None if candidate is None else candidate.rows(f, i)
        if keep:
            residual[0][t].copy_(f[RES_LO:RES_HI])
            residual[1][t].copy_(i)
            residual[2][t].copy_(k)
            if ext is not None:
                residual[3][t].copy_(ext)
        f, i, k = step_fwd(meta, cfg, tables, t, f, i, k, pix, sb, ext, images)
    return (f, i, k), residual


def scan_backward(meta, cfg, outer_steps, tables, residual, pix, sb, cot_f, *,
                  plain=False, candidate=None, images=None):
    """Walk the launches of `scan_forward` in reverse from the cotangent of
    the final float state, carrying the state cotangent and summing the table
    cotangents. With `candidate`, each step's `d_ext` is pushed back through
    a replay of its candidate (`ExtCandidate.pullback`), which adds the rays'
    share to the carried cotangent and sums the rest in the candidate.
    Returns one gradient per table of `tables`, None for the tables that hold
    no differentiable entry."""
    res_f, res_i, res_k = residual[:3]
    cot = cot_f.contiguous()
    dev = cot.device
    # the index tensors first: their host-to-device copies would otherwise
    # make the host wait for the whole loop below
    didx = {name: torch.as_tensor(idx, dtype=torch.int64, device=dev)
            for name, idx in diff_indices(meta).items()}
    d_tab = torch.zeros((n_diff(meta),), dtype=torch.float32, device=dev)
    for t in reversed(range(outer_steps)):
        ext = None if candidate is None else residual[3][t]
        args = (meta, cfg, tables, t, res_f[t], res_i[t], res_k[t], pix, sb, cot)
        if plain:
            out = ad_step_bwd_plain(*args, ext, images)
            d_tab += out[1]
        else:
            out = ad_step_bwd(*args, d_tab, ext, images)
        cot = out[0]
        if candidate is not None:
            candidate.pullback(res_f[t], res_i[t], out[2], cot)
    grads = [None] * len(tables)
    o = 0
    for name, k in _DIFF_TABLES:
        g = torch.zeros_like(tables[k])
        g[didx[name]] = d_tab[o:o + didx[name].numel()]
        o += didx[name].numel()
        grads[k] = g
    return grads


class FusedADScan(torch.autograd.Function):
    """The whole scan: forward loops the step and keeps each launch's entry
    state; backward walks the launches in reverse (`scan_backward`) and hands
    the packed tables their gradients. With a `candidate` (an
    `ExtCandidate`: the hybrid-ext scan), its inputs follow the tables and
    get the sums of its pullbacks."""

    @staticmethod
    def forward(ctx, meta, cfg, outer_steps, candidate, images, f0, i0, k0, pix, sb, n_tables,
                *tensors):
        tabs = [t.detach() for t in tensors[:n_tables]]
        (f, _, _), ctx.residual = scan_forward(
            meta, cfg, outer_steps, tabs, f0, i0, k0, pix, sb,
            keep=any(ctx.needs_input_grad), candidate=candidate, images=images)
        ctx.meta, ctx.cfg, ctx.outer_steps = meta, cfg, outer_steps
        ctx.candidate, ctx.images, ctx.lanes = candidate, images, (pix, sb)
        ctx.tables = tabs
        return f

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, cot_f):
        cand = ctx.candidate
        if cand is not None:
            cand.start_pullback()
        grads = scan_backward(ctx.meta, ctx.cfg, ctx.outer_steps, ctx.tables, ctx.residual,
                              *ctx.lanes, cot_f, candidate=cand, images=ctx.images)
        # the first state is built from camera rays: no cotangent leaves here
        return (None,) * 11 + tuple(grads) + (tuple(cand.grads) if cand is not None else ())


class ExtCandidate:
    """The candidate from outside of each step of the hybrid-ext scan: the
    nearest hit over a scene's big sphere, triangle and box sets and its
    record (`hybrid._external_candidate`), through the sweeps' kernels (or
    their plain versions with `plain`), and its pullback.

    It is differentiable in `inputs()`: the sweeps' coefficient tables in
    scene order (`hybrid.ext_coefficients`, built here with the scene's
    autograd history) and the scene's leaves that the records and the
    material read. `rows` computes it without gradients; `pullback` replays
    it from a step's saved entry state under autograd, adds the cotangent of
    the rays to the state's cotangent and sums that of the inputs over the
    steps (`grads`). The sweeps' cluster tables are built once, without
    gradients (they are permuted copies of the coefficients)."""

    def __init__(self, scene: T.SceneData, plain: bool = False):
        from miniraytracer_tpu_torch.parallel.train import TrainParams

        self.leaf_names = TrainParams._fields
        self.plain = plain
        with torch.no_grad():
            self.accel = hybrid.hybrid_accel(scene)
        self.coeffs = hybrid.ext_coefficients(scene, self.accel)
        self.keys = sorted(self.coeffs)
        self.leaves = [getattr(scene, name) for name in self.leaf_names]
        self.scene = dataclasses.replace(
            scene, **{name: leaf.detach() for name, leaf in zip(self.leaf_names, self.leaves)})
        self.ptab = noise.noise_tables(scene) if scene.has_perlin else None
        # earth's class has no external type: constant rows, nothing to replay
        self.replays = bool(self.accel) or hybrid._ext_types(scene)[2]
        self._const = {k: tuple(c.detach() for c in self.coeffs[k]) for k in self.keys}
        self._req = None
        self.grads = None

    def inputs(self):
        return [c for k in self.keys for c in self.coeffs[k]] + self.leaves

    def _rows(self, scene, coeffs, ro, rd, time, inside, alive):
        rays = ix.Rays(ro=ro, rd=rd, time=time, inside=inside)
        return hybrid._external_candidate(scene, self.accel, rays, alive, B.TMIN, self.ptab,
                                          self.plain, coeffs)

    def rows(self, f, i):
        """(NE, N) rows of the lanes of the float and int state (f, i)."""
        with torch.no_grad():
            return torch.stack(self._rows(
                self.scene, self._const, V3(*f[A_RO:A_RO + 3]), V3(*f[A_RD:A_RD + 3]),
                f[A_TIME], i[J_INSIDE], f[A_ALIVE] > 0.0)).contiguous()

    def start_pullback(self):
        """Inputs that require grad, standing in for `inputs()` in the
        replays, and zero sums of their gradients."""
        consts = [c for k in self.keys for c in self._const[k]]
        consts += [getattr(self.scene, name) for name in self.leaf_names]
        req = [c.detach().clone().requires_grad_(True) for c in consts]
        coeffs, o = {}, 0
        for k in self.keys:
            m = len(self._const[k])
            coeffs[k] = tuple(req[o:o + m])
            o += m
        scene = dataclasses.replace(self.scene, **dict(zip(self.leaf_names, req[o:])))
        self._req = (scene, coeffs, req)
        self.grads = [torch.zeros_like(r) for r in req]

    def pullback(self, res_f, res_i, d_ext, cot):
        """Replay the candidate of a step from its saved entry state (res_f
        (RES_HI - RES_LO, N), res_i (NJ, N)) and push `d_ext` through it: the
        rays' share is added into `cot` (NF, N) in place."""
        if not self.replays:
            return
        scene, coeffs, req = self._req
        r = lambda row: row - RES_LO
        with torch.enable_grad():
            rays = [res_f[r(A_RO) + k].detach().clone().requires_grad_(True) for k in range(3)]
            rays += [res_f[r(A_RD) + k].detach().clone().requires_grad_(True) for k in range(3)]
            rays.append(res_f[r(A_TIME)].detach().clone().requires_grad_(True))
            rows = self._rows(scene, coeffs, V3(*rays[:3]), V3(*rays[3:6]), rays[6],
                              res_i[J_INSIDE], res_f[r(A_ALIVE)] > 0.0)
            pairs = [(row, d_ext[j]) for j, row in enumerate(rows) if row.requires_grad]
            grads = torch.autograd.grad([p for p, _ in pairs], rays + req,
                                        grad_outputs=[g for _, g in pairs], allow_unused=True)
        for row, g in zip((A_RO, A_RO + 1, A_RO + 2, A_RD, A_RD + 1, A_RD + 2, A_TIME), grads):
            if g is not None:
                cot[row] += g
        for acc, g in zip(self.grads, grads[7:]):
            if g is not None:
                acc += g


def residual_bytes(n_lanes: int, outer_steps: int, ne: int = 0) -> int:
    """Bytes the scan keeps for the backward pass; `ne` candidate rows a lane
    and step in the hybrid-ext scan (`ext_rows`)."""
    return 4 * (RES_HI - RES_LO + NJ + 1 + ne) * n_lanes * outer_steps


def scan_plan(spp, max_bounces, scan_steps=0, sub_steps=0):
    """(scan_steps, claim_limit, k_sub, outer_steps) of a scan. The default
    `scan_steps` is `spp*6 + max_bounces + 1`; samples are claimed only
    before `claim_limit = scan_steps - (max_bounces + 1)`, so every claimed
    sample finishes; `k_sub` sub-steps run per launch (default 4)."""
    if scan_steps <= 0:
        scan_steps = spp * 6 + max_bounces + 1
    claim_limit = scan_steps - (max_bounces + 1)
    if claim_limit < 0:
        raise ValueError(f"scan_steps {scan_steps} is shorter than one path "
                         f"of {max_bounces + 1} bounces")
    k_sub = sub_steps if sub_steps > 0 else 4
    if k_sub > MAX_SUB_STEPS:
        raise ValueError(f"sub_steps must be at most {MAX_SUB_STEPS}")
    return scan_steps, claim_limit, k_sub, -(-scan_steps // k_sub)


def initial_state(scene, pix, sb, spp, *, width, height, sq_off):
    """Lane state before the first step: sample `sb` of each pixel's camera
    ray (not differentiable). Returns (fstate, istate, keys)."""
    with torch.no_grad():
        n = pix.shape[0]
        pix64, sb64 = pix.to(torch.int64), sb.to(torch.int64)
        keys0 = rng.ray_key(pix64, sb64)
        ci = sb64 % (sq_off * sq_off)
        off_x = vdiv(torch.div(ci, sq_off, rounding_mode="floor").to(torch.float32) + 0.5,
                     sq_off)
        off_y = vdiv((ci % sq_off).to(torch.float32) + 0.5, sq_off)
        x = (pix64 % width).to(torch.float32)
        y = torch.div(pix64, width, rounding_mode="floor").to(torch.float32)
        rays0 = cam_mod.get_rays(scene.camera, vdiv(x + off_x, width),
                                 vdiv(y + off_y, height), keys0)
        zero = torch.zeros((n,), dtype=torch.float32, device=pix.device)
        one = zero + 1.0
        alive0 = one if spp > 0 else zero
        fstate = torch.stack([
            zero, zero, zero, *rays0.ro, *rays0.rd, zero + rays0.time,
            one, one, one, zero, zero, zero, alive0, zero, zero])
        izero = torch.zeros((n,), dtype=torch.int32, device=pix.device)
        istate = torch.stack([izero, rays0.inside, izero])
        return fstate, istate, _keys_i32(keys0)


def can_fuse_ad_ext(scene: T.SceneData) -> bool:
    """Hybrid-ext AD eligibility, the JAX package's rule: outside the fused
    class and inside the hybrid step's (`hybrid.can_hybrid`)."""
    return not B.can_fuse(scene) and hybrid.can_hybrid(scene)


def sample_pixel_sums_fused(scene, pix, samp_base, spp, *, width, height,
                            max_bounces, sq_off=8, scan_steps=0, sub_steps=0,
                            use_ext=False, pack_plan=None):
    """Differentiable (finite-radiance sum, valid count) per pixel over `spp`
    consecutive samples starting at `samp_base`, through the fused step
    kernels on the scene's device (plain versions for a CPU scene).

    pix: (N,) int32 pixel ids on the scene's device; samp_base: an int or an
    (N,) int32 tensor, the absolute index of each lane's first sample.
    Stratified offsets are the sq_off^2 grid indexed by sample % sq_off^2.

    `use_ext` (scenes of `hybrid.can_hybrid`; the train step takes it for
    those of `can_fuse_ad_ext`): the hybrid-ext scan, one
    sub-step a launch, with the candidate from outside each step
    (`ExtCandidate`); `pack_plan` is ext-material mode's compaction plan
    (`hybrid.smem_plan`, made from the scene when None).

    Returns (sum (N, 3), nvalid (N,), rays traced (0-d int64 tensor)). The
    sum carries gradients to the scene leaves in `parallel.train.TrainParams`.
    """
    if pix.dtype != torch.int32 or pix.dim() != 1 or pix.device != scene.device:
        raise ValueError("pix must be a 1-D int32 tensor on the scene's device")
    if use_ext:
        if not hybrid.can_hybrid(scene):
            raise ValueError(f"scene {scene.name!r} is outside the hybrid step's class "
                             "(see hybrid.can_hybrid)")
        if sub_steps > 1:
            raise ValueError("the hybrid-ext scan takes one sub-step a launch")
        meta, tables = hybrid.pack_scene_hybrid(scene, pack_plan)
        sub_steps = 1
    else:
        if not B.can_fuse(scene):
            raise ValueError(f"scene {scene.name!r} is outside the fused class "
                             "(see bounce.can_fuse)")
        meta, tables = B.pack_scene(scene)
    _check_meta(meta, use_ext)
    scan_steps, claim_limit, k_sub, outer_steps = scan_plan(
        spp, max_bounces, scan_steps, sub_steps)
    cfg = StepConfig(width, height, sq_off, max_bounces, spp, claim_limit, k_sub)
    n = pix.shape[0]
    sb = torch.as_tensor(samp_base, dtype=torch.int32, device=pix.device)
    sb = sb.reshape(-1).expand(n).contiguous()
    f0, i0, k0 = initial_state(scene, pix, sb, spp, width=width, height=height,
                               sq_off=sq_off)
    cand = ExtCandidate(scene) if use_ext else None
    images = scene.images if meta["image"] else None
    f = FusedADScan.apply(meta, cfg, outer_steps, cand, images, f0, i0, k0, pix, sb,
                          len(tables), *tables, *(cand.inputs() if use_ext else ()))
    rays = f[A_RAYS].detach().to(torch.int64).sum()
    return f[A_SUM:A_SUM + 3].t(), f[A_NV].detach(), rays
