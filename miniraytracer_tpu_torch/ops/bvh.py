"""Flat-BVH ray traversal over the triangle table: a per-lane stack walk.

The port of `miniraytracer_tpu/ops/bvh.py`. Every ray carries its own short
stack and current node; all lanes step together with masked updates, in a
host loop with one `any(active)` read by the host a step, like the port's
other loops. Node visits are ordered by the ray's direction octant through
the builder's order codes (the reference's `node_order & dirMask`,
scene_object.h:224-231 / triangle.h:282-322). Unlike the reference, which
returns early on any closer child's hit (quirk SURVEY.md 9.1), the walk is
exact: a subtree is culled only when its slab entry lies beyond the best t
so far.

Node and triangle fetches are plain indexing, and the push is an indexed
write at (lane, stack pointer); the JAX package's one-hot lookups
(`ops/lookup.lookup_cols`) exist only for the TPU's gather cost. No renderer
calls the walk, in either package: it is a component held against the
brute-force sweep and timed against the clustered sweep B10 (`chip_smoke.py`
phase 35).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from miniraytracer_tpu_torch.ops import intersect as ix
from miniraytracer_tpu_torch.ops.vecmath import V3
from miniraytracer_tpu_torch.scene import types as T
from miniraytracer_tpu_torch.utils import runtime as rt

INF = ix.INF
MAX_STACK = 48  # depth bound: a balanced tree of 2^24 primitives fits


class BVH(NamedTuple):
    """Flat BVH over the scene's triangle table, on the scene's device."""

    bmin: torch.Tensor  # (M,3)
    bmax: torch.Tensor  # (M,3)
    left: torch.Tensor  # (M,) i32; leaf: -1
    first: torch.Tensor  # (M,) i32 into prim_order
    count: torch.Tensor  # (M,) i32; 0 = interior
    order: torch.Tensor  # (M,) i32 8-octant left-first bits
    prim_order: torch.Tensor  # (n,) i32 triangle row permutation
    leaf_size: int


def build_tri_bvh(scene: T.SceneData, leaf_size: int = 4) -> BVH | None:
    """Host-side build (`utils/runtime.bvh_build`) over the ACTIVE triangles;
    None when there is none."""
    m, u, v = (t.detach().cpu().numpy() for t in (scene.tri_m, scene.tri_u, scene.tri_v))
    active = scene.tri_active.cpu().numpy()
    if not active.any():
        return None
    b, c = m + u, m + v
    bmin = np.minimum(np.minimum(m, b), c)
    bmax = np.maximum(np.maximum(m, b), c)
    # inactive rows: collapsed to a far-away point, so they land in one leaf
    bmin[~active] = np.float32(1e30)
    bmax[~active] = np.float32(1e30)
    nb, nm, po = rt.bvh_build(bmin, bmax, leaf_size=leaf_size)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(scene.device)
    return BVH(bmin=to(nb[:, :3]), bmax=to(nb[:, 3:]), left=to(nm[:, 0]), first=to(nm[:, 1]),
               count=to(nm[:, 2]), order=to(nm[:, 3]), prim_order=to(po), leaf_size=leaf_size)


def bvh_tri_hit(bvh: BVH, scene: T.SceneData, rays: ix.Rays, tmin=ix.TMIN, stats=None):
    """Nearest triangle hit by the BVH walk: (t (N,) f32, idx (N,) i32), t =
    INF and idx 0 on a miss, like the brute-force sweep. `stats`, a dict,
    receives "steps" (walk steps, one host read each)."""
    ro, rd = rays.ro, rays.rd
    n = rays.time.shape[0]
    rows = torch.arange(n, device=rays.time.device)
    safe_inv = lambda d: 1.0 / torch.where(torch.abs(d) > 1e-30, d, 1e-30)
    inv = V3(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z))
    # 3-bit direction octant (ray.h:20-27): bit k set when dir[k] < 0
    octant = ((rd.x < 0).to(torch.int32) + 2 * (rd.y < 0).to(torch.int32)
              + 4 * (rd.z < 0).to(torch.int32))
    sign_flip = rays.inside > 0
    last_slot = bvh.prim_order.shape[0] - 1

    def slab(lo, hi, best_t):
        t0 = (lo - ro) * inv
        t1 = (hi - ro) * inv
        enter = torch.maximum(torch.maximum(torch.minimum(t0.x, t1.x), torch.minimum(t0.y, t1.y)),
                              torch.minimum(t0.z, t1.z))
        exit_ = torch.minimum(torch.minimum(torch.maximum(t0.x, t1.x), torch.maximum(t0.y, t1.y)),
                              torch.maximum(t0.z, t1.z))
        # strict test like aabb.h:76, and a cull beyond the best hit so far
        return (exit_ > torch.clamp_min(enter, tmin)) & (enter < best_t) & (exit_ > tmin)

    def leaf_intersect(first, count, best_t, best_i):
        """Moller-Trumbore (triangle.cpp:221-264) on each of the leaf's slots."""
        for k in range(bvh.leaf_size):
            tri = bvh.prim_order[torch.clamp(first + k, 0, last_slot)].long()
            m, u, v = (V3(*tab[tri].unbind(1)) for tab in (scene.tri_m, scene.tri_u, scene.tri_v))
            px = rd.y * v.z - rd.z * v.y
            py = rd.z * v.x - rd.x * v.z
            pz = rd.x * v.y - rd.y * v.x
            det = u.x * px + u.y * py + u.z * pz
            sign = torch.where(sign_flip & (det < 0.0), -1.0, 1.0)
            sdet = det * sign
            tx = ro.x - m.x
            ty = ro.y - m.y
            tz = ro.z - m.z
            uu = (tx * px + ty * py + tz * pz) * sign
            qx = ty * u.z - tz * u.y
            qy = tz * u.x - tx * u.z
            qz = tx * u.y - ty * u.x
            vv = (rd.x * qx + rd.y * qy + rd.z * qz) * sign
            tval = (v.x * qx + v.y * qy + v.z * qz) / torch.where(
                torch.abs(det) > ix.TRI_EPS, det, 1.0)
            ok = ((k < count) & scene.tri_active[tri] & (sdet >= ix.TRI_EPS)
                  & (uu >= 0) & (uu <= sdet) & (vv >= 0) & (uu + vv <= sdet)
                  & (tval >= tmin) & (tval < best_t))
            best_i = torch.where(ok, tri.to(torch.int32), best_i)
            best_t = torch.where(ok, tval, best_t)
        return best_t, best_i

    stack = torch.zeros((n, MAX_STACK), dtype=torch.int32, device=rows.device)
    sp = torch.zeros((n,), dtype=torch.int64, device=rows.device)
    node = torch.zeros((n,), dtype=torch.int32, device=rows.device)  # the root
    best_t = torch.full((n,), INF, dtype=torch.float32, device=rows.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=rows.device)
    active = torch.ones((n,), dtype=torch.bool, device=rows.device)
    steps = 0
    while bool(active.any()):
        idx = torch.clamp_min(node, 0).long()
        left, first, count, order = (f[idx] for f in (bvh.left, bvh.first, bvh.count, bvh.order))
        hit_box = (slab(V3(*bvh.bmin[idx].unbind(1)), V3(*bvh.bmax[idx].unbind(1)), best_t)
                   & active & (node >= 0))
        is_leaf = count > 0

        # leaves: masked triangle tests
        do_leaf = hit_box & is_leaf
        best_t, best_i = leaf_intersect(torch.where(do_leaf, first, 0),
                                        torch.where(do_leaf, count, 0), best_t, best_i)

        # interior: the near child goes on, the far child is pushed
        go_in = hit_box & ~is_leaf
        left_first = ((order >> octant) & 1) > 0
        near = torch.where(left_first, left, left + 1)
        far = torch.where(left_first, left + 1, left)
        top = torch.clamp(sp, 0, MAX_STACK - 1)
        stack[rows, top] = torch.where(go_in, far, stack[rows, top])
        sp = torch.where(go_in, torch.clamp_max(sp + 1, MAX_STACK), sp)

        # next node: the near child when descending, else a pop
        can_pop = sp > 0
        popped = stack[rows, torch.clamp(sp - 1, 0, MAX_STACK - 1)]
        node = torch.where(go_in, near, torch.where(can_pop, popped, -1))
        sp = torch.where(go_in, sp, torch.where(can_pop, sp - 1, sp))
        active = active & (node >= 0)
        steps += 1
    if stats is not None:
        stats["steps"] = steps
    return best_t, best_i
