"""Wavefront OBJ meshes (`miniraytracer_tpu/scene/obj_loader.py`, the
reference's obj_loader.cpp:14-163), parsed in Python.

The subset the reference reads: `v x y z`, `vn x y z` and triangular faces
`f a b c` or `f a//an b//bn c//cn` (1-based, no texture coordinates, no
negative indices). Vertices are scaled, rotated about y and translated;
normals get the rotation (obj_loader.cpp:80-133). `flip` swaps the winding
(a <-> c).
"""

from __future__ import annotations

import math

import numpy as np

_F = np.float32


def _roty(deg):
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], _F)


def obj_parse(path):
    """(vertices (V,3) f32, normals (N,3) f32, faces (F,6) i32 [v0 v1 v2 n0 n1
    n2]) of the OBJ file at `path`, 0-based, normal index -1 where a face
    names none. A face whose vertex index does not parse is skipped."""
    verts, normals, faces = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v" and len(parts) >= 4:
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn" and len(parts) >= 4:
                normals.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f" and len(parts) >= 4:
                vi, ni = [], []
                for tok in parts[1:4]:
                    seg = tok.split("/")
                    try:
                        vi.append(int(seg[0]) - 1)
                    except ValueError:
                        break
                    ni.append(int(seg[2]) - 1 if len(seg) >= 3 and seg[2] else -1)
                else:
                    faces.append(vi + ni)
    return (np.asarray(verts, _F).reshape(-1, 3), np.asarray(normals, _F).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 6))


def read_obj(path, scale=1.0, rot_y_deg=0.0, translate=(0, 0, 0), flip=False):
    """The triangles of an OBJ file as (a, b, c, n_a, n_b, n_c), each (T, 3)
    f32: per-vertex normals where the file gives them, else the flat
    geometric normal (the triangle constructor without normals)."""
    V, N, F = obj_parse(path)
    if F.shape[0] == 0:
        z = np.zeros((0, 3), _F)
        return z, z, z, z, z, z
    R = _roty(rot_y_deg)
    Vt = (V * _F(scale)) @ R.T + np.asarray(translate, _F)
    vi, ni = (F[:, [2, 1, 0]], F[:, [5, 4, 3]]) if flip else (F[:, :3], F[:, 3:])
    a, b, c = Vt[vi[:, 0]], Vt[vi[:, 1]], Vt[vi[:, 2]]
    has_n = (ni >= 0).all(axis=1) & (N.shape[0] > 0)
    gn = np.cross(b - a, c - a)
    ln = np.linalg.norm(gn, axis=1, keepdims=True)
    gn = np.where(ln > 0, gn / np.maximum(ln, 1e-30), gn)

    def vert_n(k):
        if N.shape[0] == 0:
            return gn
        # a pure rotation: n' = R n (the reference's row vector times the
        # inverse rotation, obj_loader.cpp:117-119)
        nn = N[np.clip(ni[:, k], 0, N.shape[0] - 1)] @ R.T
        return np.where(has_n[:, None], nn, gn)

    return tuple(np.asarray(x, _F) for x in (a, b, c, vert_n(0), vert_n(1), vert_n(2)))
