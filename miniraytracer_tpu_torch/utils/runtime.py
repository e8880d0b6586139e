"""Host-side runtime work in NumPy: the BVH build and the tile order.

The NumPy forms of `miniraytracer_tpu/utils/runtime.py`: `bvh_build` is its
`_bvh_build_numpy` (the layout and semantics of the reference's builder,
triangle.h:78-152 / scene_object.h:283-319) and `tile_order` its
`_tile_order_numpy` (work_queue.cpp:33-127); both give the same arrays.

The JAX package also binds a native builder (`csrc/libmrt_runtime.so`,
through ctypes). The port leaves it out: the BVH is built once per scene
on the host, and a NumPy build of the triangles scene's 11,264 stand-in
triangles is a one-off cost (`chip_smoke.py` phase 35 times it; PERF.md).
OBJ parsing lives in `scene/obj_loader.py`.
"""

from __future__ import annotations

import sys

import numpy as np

# depth past which splits MUST be at the median: midpoint partitions can
# degenerate to 1:(n-1) and overflow the traversal's fixed stack
# (`ops/bvh.py` MAX_STACK = 48). The median halves the count, so the depth is
# at most 22 + ceil(log2(n)) <= 46 < 48 for n < 16M.
MEDIAN_DEPTH = 22


def bvh_build(bmin: np.ndarray, bmax: np.ndarray, leaf_size: int = 4):
    """Build a flat BVH over primitive AABBs (n, 3) / (n, 3).

    Returns (node_bounds (M,6) f32, node_meta (M,4) i32 [left, first, count,
    order], prim_order (n,) i32). Interior nodes have count == 0 and children
    (left, left+1); leaves index prim_order[first:first+count]. `order` holds,
    for each of the 8 direction octants (bit k set when dir[k] < 0), whether
    the left child is the nearer one.
    """
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    n = bmin.shape[0]
    if bmin.shape != (n, 3) or bmax.shape != (n, 3):
        raise ValueError(f"bmin and bmax must be (n, 3), not {bmin.shape} and {bmax.shape}")
    centroid = 0.5 * (bmin + bmax)
    order = np.arange(n, dtype=np.int32)
    bounds, meta = [], []

    def new_node(first, count):
        idx = len(bounds)
        sel = order[first:first + count]
        bounds.append(np.concatenate([bmin[sel].min(0), bmax[sel].max(0)]))
        meta.append([-1, first, count, 0])
        return idx

    def order_code(li, axis):
        lc = 0.5 * (bounds[li][axis] + bounds[li][3 + axis])
        rc = 0.5 * (bounds[li + 1][axis] + bounds[li + 1][3 + axis])
        code = 0
        for oct_ in range(8):
            dir_neg = (oct_ >> axis) & 1
            left_first = (lc >= rc) if dir_neg else (lc <= rc)
            if left_first:
                code |= 1 << oct_
        return code

    def subdivide(ni, depth):
        _, first, count, _ = meta[ni]
        if count <= leaf_size:
            return
        sel = order[first:first + count]
        c = centroid[sel]
        ext = c.max(0) - c.min(0)
        axis = int(np.argmax(ext))
        if ext[axis] <= 0:
            mid = first + count // 2
        elif depth >= MEDIAN_DEPTH:
            order[first:first + count] = sel[np.argsort(c[:, axis], kind="stable")]
            mid = first + count // 2
        else:
            split = 0.5 * (c[:, axis].min() + c[:, axis].max())
            left_mask = c[:, axis] < split
            order[first:first + count] = np.concatenate([sel[left_mask], sel[~left_mask]])
            mid = first + int(left_mask.sum())
            if mid == first or mid == first + count:
                sel = order[first:first + count]
                key = centroid[sel][:, axis]
                order[first:first + count] = sel[np.argsort(key, kind="stable")]
                mid = first + count // 2
        li = new_node(first, mid - first)
        new_node(mid, first + count - mid)
        meta[ni] = [li, first, 0, order_code(li, axis)]
        subdivide(li, depth + 1)
        subdivide(li + 1, depth + 1)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * n))
    try:
        new_node(0, n)
        subdivide(0, 0)
    finally:
        sys.setrecursionlimit(old_limit)
    return np.asarray(bounds, np.float32), np.asarray(meta, np.int32), order


# ---------------------------------------------------------------------------
# Tile order
# ---------------------------------------------------------------------------

TILE_ROW_MAJOR = 0
TILE_MORTON = 1
TILE_HILBERT = 2
TILE_INVERT = 16  # bit-reversed sequence ("inverted", the reference default)


def _hilbert_d2xy(side, d):
    x = y = 0
    s = 1
    t = d
    while s < side:
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        if ry == 0:
            if rx == 1:
                x = s - 1 - x
                y = s - 1 - y
            x, y = y, x
        x += s * rx
        y += s * ry
        t //= 4
        s *= 2
    return x, y


def tile_order(tiles_x: int, tiles_y: int, mode: int = TILE_HILBERT | TILE_INVERT):
    """Tile visit order (indices tx + ty*tiles_x) along the selected curve,
    (tiles_x * tiles_y,) int32: the reference's inverted-Hilbert shuffle by
    default (work_queue.cpp:84-127)."""
    side = 1
    while side < max(tiles_x, tiles_y):
        side *= 2
    cells = side * side
    bits = cells.bit_length() - 1
    invert = bool(mode & TILE_INVERT)
    kind = mode & 15
    out = []
    for d in range(cells):
        dd = int(format(d, f"0{bits}b")[::-1], 2) if invert and bits else d
        if kind == TILE_HILBERT:
            x, y = _hilbert_d2xy(side, dd)
        elif kind == TILE_MORTON:
            x = y = 0
            for b in range(16):
                x |= ((dd >> (2 * b)) & 1) << b
                y |= ((dd >> (2 * b + 1)) & 1) << b
        else:
            x, y = dd % side, dd // side
        if x < tiles_x and y < tiles_y:
            out.append(x + y * tiles_x)
    return np.asarray(out, np.int32)


def tile_pixel_batches(width: int, height: int, tilesize: int, n_batches: int = 8,
                       mode: int = TILE_HILBERT | TILE_INVERT):
    """The frame's pixel ids (x + y*width) in `n_batches` batches of one size
    that together sweep the tiles in `tile_order`: the progressive preview's
    schedule (work_queue.cpp:84-127), which refines the frame uniformly like
    the reference's live window. The last batch is padded by repeating the
    last pixel id. Returns a list of (B,) int64 numpy arrays."""
    tilesize = max(1, int(tilesize))
    tx = -(-width // tilesize)
    ty = -(-height // tilesize)
    ids = np.empty((width * height,), np.int64)
    pos = 0
    for t in tile_order(tx, ty, mode):
        x0 = int(t % tx) * tilesize
        y0 = int(t // tx) * tilesize
        xs = np.arange(x0, min(x0 + tilesize, width))
        ys = np.arange(y0, min(y0 + tilesize, height))
        tile_ids = (xs[None, :] + ys[:, None] * width).ravel()
        ids[pos:pos + tile_ids.size] = tile_ids
        pos += tile_ids.size
    n_batches = max(1, min(n_batches, width * height))
    bsize = -(-ids.size // n_batches)
    padded = np.concatenate([ids, np.full((bsize * n_batches - ids.size,), ids[-1], np.int64)])
    return [padded[i * bsize:(i + 1) * bsize] for i in range(n_batches)]
