"""The nine built-in scenes (scene.cpp:25-529), compiled to SceneData
tables exactly as `miniraytracer_tpu/models/scenes.py` builds them, and the
procedural scenes of the tests and of `chip_smoke.py`.

Scene-gen randomness replicates the reference's deterministic main-thread
stream (PCG32 with the fixed constants of main.cpp:302), so object placement
matches the reference and the JAX package bit for bit.

Assets come from the directory that `MRT_ASSETS` names: `earthmap.jpg` (else
a procedural map) and `obj/bunny.obj`, `obj/Teapot3_no_vt.obj` (else the
triangles scene has no meshes, as the reference's `if (tris && bunny)`
guards allow, scene.cpp:504-513). `write_stand_in_meshes` writes stand-ins
for the two mesh files, of the reference's size, where the real ones are
absent.
"""

from __future__ import annotations

import math
import os

import numpy as np

from miniraytracer_tpu_torch.ops.rng import Pcg32
from miniraytracer_tpu_torch.scene.builder import SceneBuilder, _roty_fwd
from miniraytracer_tpu_torch.scene.obj_loader import read_obj

# scene ids (scene.h:6-17)
SCENE_RANDOM_SPHERES = 0
SCENE_RANDOM_SPHERES_2 = 1
SCENE_TWO_SPHERES = 2
SCENE_PERLIN_SPHERES = 3
SCENE_EARTH = 4
SCENE_CORNELL_BOX = 5
SCENE_CORNELL_SMOKE = 6
SCENE_BOOK2_FINAL = 7
SCENE_TRIANGLES = 8

SCENE_NAMES = [
    "random_spheres", "random_spheres_2", "two_spheres", "perlin_spheres",
    "earth", "cornell_box", "cornell_smoke", "book2_final", "triangles",
]


def _book1_camera(b: SceneBuilder, aspect):
    """Shared camera of the book-1 style scenes (scene.cpp:54-63)."""
    pos = np.array([11, 2.2, 2.5], np.float32)
    look = np.array([2.8, 0.5, 1.2], np.float32)
    b.set_camera(pos, look, [0, 1, 0], 27.0, aspect, 0.09,
                 float(np.linalg.norm(pos - look)), 0.0, 1.0)


def _scene_rng() -> Pcg32:
    """Deterministic scene-gen stream (main.cpp:302)."""
    return Pcg32(11350390909718046443, 6305599193148252115)


def _load_earthmap():
    """earthmap.jpg from the directory named by MRT_ASSETS, via PIL; without
    the file (or PIL) the procedural blue-green latitude bands the JAX
    package falls back to, so the scene still renders."""
    asset_dir = os.environ.get("MRT_ASSETS")
    if asset_dir:
        try:
            from PIL import Image

            with Image.open(os.path.join(asset_dir, "earthmap.jpg")) as im:
                return np.asarray(im.convert("RGB"), np.uint8)
        except (ImportError, OSError):
            pass
    h, w = 256, 512
    y = np.linspace(0, 1, h)[:, None]
    img = np.stack(
        [np.full((h, w), 0.2), 0.3 + 0.4 * np.tile(np.abs(np.sin(6 * np.pi * y)), (1, w)), np.full((h, w), 0.6)],
        axis=-1,
    )
    return (img * 255).astype(np.uint8)


def random_spheres(aspect, n=500):
    """Shirley book-1 final (scene.cpp:51-119): ~487 spheres, a material
    each, moving lambertians, metals, glass, under the sky."""
    g = _scene_rng()
    b = SceneBuilder()
    b.name = "random_spheres"
    _book1_camera(b, aspect)
    checker = b.tex_checker([0.2, 0.3, 0.1], [0.9, 0.9, 0.9], 10.0)
    b.sphere([0, -1000, 0], 1000, b.lambertian(checker))

    half = int(math.sqrt(float(n)) * 0.5)
    for a in range(-half, half):
        for bb in range(-half, half):
            # C++ evaluates constructor arguments right to left (MSVC/GCC): in
            # `Vec3(a + 0.9f*randf(), 0.2f, b + 0.9f*randf())` the z draw
            # comes first; in `new metal(new color_tex(Vec3(r,g,b)), gloss)`
            # the gloss draw precedes the colour draws, which land b, g, r
            choose = g.randf()
            cz = bb + 0.9 * g.randf()
            cx = a + 0.9 * g.randf()
            center = np.array([cx, 0.2, cz], np.float32)
            if np.linalg.norm(center - np.array([4, 0.2, 0], np.float32)) > 0.9:
                if choose < 0.5:
                    cb = g.randf() * g.randf()
                    cg = g.randf() * g.randf()
                    cr = g.randf() * g.randf()
                    m = b.lambertian(b.tex_const([cr, cg, cb]))
                    c1 = center + np.array([0, 0.5 * g.randf(), 0], np.float32)
                    b.sphere(center, 0.2, m, center1=c1, t0=0.0, t1=1.0)
                elif choose < 0.9:
                    gloss = g.randf()
                    cb = 0.5 * (1 + g.randf())
                    cg = 0.5 * (1 + g.randf())
                    cr = 0.5 * (1 + g.randf())
                    m = b.metal(b.tex_const([cr, cg, cb]), gloss)
                    b.sphere(center, 0.2, m)
                else:
                    m = b.dielectric(1.4 + g.randf())
                    b.sphere(center, 0.2, m)

    b.sphere([0, 1, 0], 1.0, b.dielectric(1.5))
    b.sphere([-4, 1, 0], 1.0, b.lambertian(b.tex_const([0.4, 0.2, 0.1])))
    b.sphere([4, 1, 0], 1.0, b.metal(b.tex_const([0.7, 0.6, 0.5]), 1.0))
    b.sphere([4, 1, 3], 1.0, b.dielectric(2.4))
    b.sphere([4, 1, 3], -0.95, b.dielectric(2.4))
    b.use_sky = True
    return b.build()


def random_spheres_2(aspect, n=500):
    """The textured variant (scene.cpp:122-203): Perlin ground, spheres of
    earth map and small-scale Perlin among the lambertians, metals and glass;
    ~487 spheres, a material each for most."""
    g = _scene_rng()
    b = SceneBuilder()
    b.name = "random_spheres_2"
    _book1_camera(b, aspect)
    earth_m = b.lambertian(b.tex_image(_load_earthmap()))
    checker = b.lambertian(b.tex_checker([0.2, 0.3, 0.1], [0.9, 0.9, 0.9], 10.0))
    perlin = b.lambertian(b.tex_perlin(1.0))
    perlin_small = b.lambertian(b.tex_perlin(4.0))

    b.sphere([0, -1000, 0], 1000, perlin)
    half = int(math.sqrt(float(n)) * 0.5)
    for a in range(-half, half):
        for bb in range(-half, half):
            # draws in the reference's order, as in random_spheres
            choose = g.randf()
            cz = bb + 0.9 * g.randf()
            cx = a + 0.9 * g.randf()
            center = np.array([cx, 0.2, cz], np.float32)
            if np.linalg.norm(center - np.array([4, 0.2, 0], np.float32)) > 0.9:
                if choose < 0.3:
                    cb = g.randf() * g.randf()
                    cg = g.randf() * g.randf()
                    cr = g.randf() * g.randf()
                    m = b.lambertian(b.tex_const([cr, cg, cb]))
                    c1 = center + np.array([0, 0.5 * g.randf(), 0], np.float32)
                    b.sphere(center, 0.2, m, center1=c1, t0=0.0, t1=1.0)
                else:
                    if choose < 0.6:
                        gloss = g.randf()
                        cb = 0.5 * (1 + g.randf())
                        cg = 0.5 * (1 + g.randf())
                        cr = 0.5 * (1 + g.randf())
                        m = b.metal(b.tex_const([cr, cg, cb]), gloss)
                    elif choose < 0.7:
                        m = b.dielectric(1.4 + g.randf())
                    elif choose < 0.75:
                        m = earth_m
                    else:
                        m = perlin_small
                    b.sphere(center, 0.2, m)

    b.sphere([0, 1, 0], 1.0, b.dielectric(1.5))
    b.sphere([-4, 1, 0], 1.0, checker)
    b.sphere([4, 1, 0], 1.0, b.metal(b.tex_const([0.7, 0.6, 0.5]), 1.0))
    b.sphere([4, 1, 3], 1.0, b.dielectric(2.4))
    b.sphere([4, 1, 3], -0.95, b.dielectric(2.4))
    b.use_sky = True
    return b.build()


def two_spheres(aspect):
    """scene.cpp:206-229."""
    b = SceneBuilder()
    b.name = "two_spheres"
    _book1_camera(b, aspect)
    checker = b.tex_checker([0.2, 0.3, 0.1], [0.9, 0.9, 0.9], 10.0)
    m = b.lambertian(checker)
    b.sphere([0, -10, 0], 10, m)
    b.sphere([0, 10, 0], 10, m)
    b.use_sky = True
    return b.build()


def perlin_spheres(aspect):
    """scene.cpp:231-252."""
    b = SceneBuilder()
    b.name = "perlin_spheres"
    _book1_camera(b, aspect)
    b.sphere([0, -1001, 0], 1000, b.lambertian(b.tex_perlin(1.0)))
    b.sphere([0, 1, 0], 2, b.lambertian(b.tex_perlin(4.0)))
    b.sphere([0.5, -0.5, 2], 0.5, b.lambertian(b.tex_perlin(16.0)))
    b.use_sky = True
    return b.build()


def earth(aspect):
    """scene.cpp:255-281."""
    b = SceneBuilder()
    b.name = "earth"
    _book1_camera(b, aspect)
    em = b.lambertian(b.tex_image(_load_earthmap()))
    b.sphere([0, -1001, 0], 1000, b.lambertian(b.tex_perlin(1.0)))
    b.sphere([0, 1, 0], 2, em)
    b.sphere([0.5, -0.5, 2], 0.5, em)
    b.use_sky = True
    return b.build()


def _cornell_camera(b: SceneBuilder, aspect, pos=(278, 278, -800), look=(278, 278, 100), aperture=0.0):
    pos = np.asarray(pos, np.float32)
    look = np.asarray(look, np.float32)
    b.set_camera(pos, look, [0, 1, 0], 40.0, aspect, aperture,
                 float(np.linalg.norm(pos - look)), 0.0, 1.0)


def cornell_box(aspect):
    """scene.cpp:284-334 (light intensity 15; only the light is
    importance-sampled — the glass sphere is excluded by the reference's
    count-1 list quirk, scene.cpp:326-329)."""
    b = SceneBuilder()
    b.name = "cornell_box"
    _cornell_camera(b, aspect)
    red = b.lambertian(b.tex_const([0.65, 0.055, 0.06]))
    white = b.lambertian(b.tex_const([0.73, 0.73, 0.73]))
    green = b.lambertian(b.tex_const([0.117, 0.44, 0.115]))
    light = b.diffuse_light(b.tex_const([15.0, 15.0, 15.0]))
    glass = b.dielectric(1.5)

    b.yz_rect(555, 0, 0, 555, 555, green)
    b.yz_rect(0, 555, 0, 555, 0, red)
    l = b.xz_rect(343, 213, 227, 332, 554, light)
    b.xz_rect(555, 0, 0, 555, 555, white)
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xy_rect(555, 0, 0, 555, 555, white)
    b.box([0, 0, 0], [165, 330, 165], white, rot_y_deg=15.0, offset=[265, 0, 295])
    b.sphere([190, 90, 190], 90, glass)

    b.add_light(l)
    b.use_sky = False
    return b.build()


def cornell_smoke(aspect):
    """scene.cpp:337-383."""
    b = SceneBuilder()
    b.name = "cornell_smoke"
    _cornell_camera(b, aspect)
    red = b.lambertian(b.tex_const([0.65, 0.05, 0.05]))
    white = b.lambertian(b.tex_const([0.73, 0.73, 0.73]))
    green = b.lambertian(b.tex_const([0.12, 0.45, 0.15]))
    light = b.diffuse_light(b.tex_const([7.0, 7.0, 7.0]))

    b.yz_rect(555, 0, 0, 555, 555, green)
    b.yz_rect(0, 555, 0, 555, 0, red)
    l = b.xz_rect(443, 113, 127, 432, 554, light)
    b.xz_rect(555, 0, 0, 555, 555, white)
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xy_rect(555, 0, 0, 555, 555, white)
    b.volume_box([0, 0, 0], [165, 165, 165], 0.01, b.tex_const([1.0, 1.0, 1.0]),
                 rot_y_deg=-18.0, offset=[130, 0, 65])
    b.volume_box([0, 0, 0], [165, 330, 165], 0.01, b.tex_const([0.0, 0.0, 0.0]),
                 rot_y_deg=15.0, offset=[265, 0, 295])

    b.add_light(l)
    b.use_sky = False
    return b.build()


def book2_final(aspect):
    """Shirley book-2 final (scene.cpp:386-478): 400 ground boxes, 1006
    spheres (one moving, one of glass around a fog, one with the earth map,
    one of Perlin marble, a cloud of 1000), a global fog and a rect light."""
    g = _scene_rng()
    b = SceneBuilder()
    b.name = "book2_final"
    _cornell_camera(b, aspect, pos=(450, 278, -560), look=(200, 278, 300))

    earth_m = b.lambertian(b.tex_image(_load_earthmap()))
    white = b.lambertian(b.tex_const([0.73, 0.73, 0.73]))
    green = b.lambertian(b.tex_const([0.48, 0.83, 0.53]))
    light = b.diffuse_light(b.tex_const([7.0, 7.0, 7.0]))
    orange = b.lambertian(b.tex_const([0.7, 0.3, 0.1]))
    perlin = b.lambertian(b.tex_perlin(0.05))

    # 20x20 ground boxes of random heights (scene.cpp:409-421)
    nb = 20
    for i in range(nb):
        for j in range(nb):
            w = 100.0
            x0 = -1000 + i * w
            z0 = -1000 + j * w
            y1 = 100 * (g.randf() + 0.01)
            b.box([x0, 0, z0], [x0 + w, y1, z0 + w], green)

    l = b.xz_rect(423, 123, 147, 412, 554, light)
    b.sphere([400, 400, 200], 50, orange, center1=[430, 400, 200], t0=0, t1=1)
    b.sphere([260, 150, 45], 50, b.dielectric(1.5))
    b.sphere([0, 150, 145], 50, b.metal(b.tex_const([0.8, 0.8, 0.9]), 0.1))
    b.sphere([400, 200, 400], 100, earth_m)
    b.sphere([220, 280, 300], 80, perlin)

    # the blue subsurface sphere: a glass boundary around a volume
    b.sphere([360, 150, 145], 70, b.dielectric(1.5))
    b.volume_sphere([360, 150, 145], 70, 0.2, b.tex_const([0.2, 0.4, 0.9]))
    # the global fog
    b.volume_sphere([0, 0, 0], 5000, 0.0001, b.tex_const([1.0, 1.0, 1.0]))

    # a cloud of 1000 white spheres in a rotated and translated box
    # (scene.cpp:445-449), the rotation and translation baked into the centres
    R = _roty_fwd(15.0)
    off = np.array([-100, 270, 395], np.float32)
    for _ in range(1000):
        # constructor arguments right to left: the draws land z, y, x
        z_ = 165 * g.randf()
        y_ = 165 * g.randf()
        x_ = 165 * g.randf()
        c = np.array([x_, y_, z_], np.float32)
        b.sphere(R @ c + off, 10, white)

    b.add_light(l)
    b.use_sky = False
    return b.build()


def ad_probe(aspect=1.0, builder_cls=SceneBuilder):
    """Not one of the reference's scenes: the branches of the differentiable
    step that the four scenes above do not reach (a sphere light, metal
    gloss, a checker, a box under the sky), i.e. every `TrainParams` leaf but
    `tri_m`. The step's kernels and their plain versions are held against
    each other on it. `builder_cls` may be any class with `SceneBuilder`'s
    interface."""
    b = builder_cls()
    b.name = "ad_probe"
    b.set_camera([0, 2, 6], [0, 0.8, 0], [0, 1, 0], 45.0, aspect,
                 aperture=0.0, focus_dist=6.0, t0=0.0, t1=0.0)
    ground = b.lambertian(b.tex_checker([0.2, 0.3, 0.1], [0.9, 0.9, 0.9], 10.0))
    b.sphere([0, -1000, 0], 1000, ground)
    b.sphere([-1.1, 0.6, 0], 0.6, b.lambertian(b.tex_const([0.7, 0.3, 0.3])))
    b.sphere([1.1, 0.5, 0.3], 0.5, b.metal(b.tex_const([0.8, 0.8, 0.9]), 0.6))
    b.box([-0.5, 0.0, -1.5], [0.5, 1.2, -0.7],
          b.lambertian(b.tex_const([0.4, 0.6, 0.8])))
    lm = b.diffuse_light(b.tex_const([1.0, 1.0, 1.0]), 7.0)
    b.add_light(b.sphere([0, 4.0, 1.0], 0.8, lm))
    b.use_sky = True
    return b.build()


def hybrid_probe(aspect=1.0, n_sph=80, n_tri=0, builder_cls=SceneBuilder):
    """Not one of the reference's scenes: more than 64 spheres (and, with
    `n_tri` > 64, triangles) that share five materials, over a ground sphere
    and under a rect light and the sky. The hybrid renderer sweeps both sets
    outside its step kernel and hands it the winner in five rows, the mode
    random_spheres (a material a sphere) does not reach. The dense nearest-hit
    kernels and the step kernel are held against their plain versions on it.
    `builder_cls` may be any class with `SceneBuilder`'s interface."""
    b = builder_cls()
    b.name = "hybrid_probe"
    b.set_camera([0, 3, 12], [0, 1, 0], [0, 1, 0], 40.0, aspect,
                 aperture=0.0, focus_dist=10.0, t0=0.0, t1=0.0)
    gray = b.lambertian(b.tex_const([0.5, 0.5, 0.5]))
    red = b.lambertian(b.tex_const([0.7, 0.2, 0.2]))
    met = b.metal(b.tex_const([0.9, 0.9, 0.9]), 0.8)
    glass = b.dielectric(1.5)
    lightm = b.diffuse_light(b.tex_const([1, 1, 1]), 7.0)
    b.sphere([0, -1000, 0], 1000, gray)
    b.add_light(b.xz_rect(-2, 2, -2, 2, 8, lightm))
    rs = np.random.RandomState(0)
    mats = [gray, red, met, glass]
    for i in range(n_sph):
        p = rs.uniform(-6, 6, 3)
        p[1] = rs.uniform(0.2, 3)
        b.sphere(p.tolist(), rs.uniform(0.1, 0.4), mats[i % 4])
    for i in range(n_tri):
        p = rs.uniform(-6, 6, 3)
        p[1] = rs.uniform(0.2, 3)
        a = p + rs.uniform(-0.4, 0.4, 3)
        c = p + rs.uniform(-0.4, 0.4, 3)
        b.triangle(p.tolist(), a.tolist(), c.tolist(), mats[i % 4])
    b.use_sky = True
    return b.build()


def _icosphere(subdiv):
    """Unit icosphere: (vertices (V,3) f64, faces (F,3) int, wound outward)."""
    g = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [(-1, g, 0), (1, g, 0), (-1, -g, 0), (1, -g, 0), (0, -1, g), (0, 1, g),
             (0, -1, -g), (0, 1, -g), (g, 0, -1), (g, 0, 1), (-g, 0, -1), (-g, 0, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
             (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
             (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdiv):
        mid = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                p = verts[a] + verts[b]
                verts.append(p / np.linalg.norm(p))
                mid[key] = len(verts) - 1
            return mid[key]

        new = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return np.stack(verts), np.asarray(faces)


def _torus(major, minor, n_major, n_minor):
    """Torus about the y axis: (vertices, outward unit normals, faces wound
    outward), 2 * n_major * n_minor triangles."""
    th = 2 * np.pi * np.arange(n_major) / n_major
    ph = 2 * np.pi * np.arange(n_minor) / n_minor
    T_, P_ = np.meshgrid(th, ph, indexing="ij")
    nrm = np.stack([np.cos(P_) * np.cos(T_), np.sin(P_), np.cos(P_) * np.sin(T_)], -1)
    ring = np.stack([np.cos(T_), np.zeros_like(T_), np.sin(T_)], -1) * major
    verts = (ring + minor * nrm).reshape(-1, 3)
    idx = lambda i, j: (i % n_major) * n_minor + (j % n_minor)
    faces = []
    for i in range(n_major):
        for j in range(n_minor):
            a, b, c, d = idx(i, j), idx(i + 1, j), idx(i + 1, j + 1), idx(i, j + 1)
            faces += [(a, c, b), (a, d, c)]
    return verts, nrm.reshape(-1, 3), np.asarray(faces)


def write_stand_in_meshes(dirpath, bunny_subdiv=4, torus_segments=(64, 48)):
    """Not one of the reference's scenes: a stand-in for the absent assets.
    Writes `obj/bunny.obj` and `obj/Teapot3_no_vt.obj` under `dirpath`, the
    two mesh files that `triangles` loads (through `MRT_ASSETS`), made here
    with numpy and written as plain text with vertex normals:

    - for the bunny, an icosphere of radius 0.05 about (0, 0.07, 0), 20 *
      4^bunny_subdiv triangles (5,120), wound inward: `triangles` loads it
      with the winding flipped;
    - for the teapot, a torus of major radius 0.3 and minor radius 0.12 about
      (0, 0.12, 0), 2 * n_major * n_minor triangles (6,144).

    At the defaults that is 11,264 triangles, the size of the reference's
    11,288; after the scene's transforms both lie inside the 555-unit box.
    Both are closed and curved everywhere: no Morton cluster of 64 of their
    triangles lies in one axis-aligned plane. Returns `dirpath`."""
    obj = os.path.join(dirpath, "obj")
    os.makedirs(obj, exist_ok=True)

    def write(name, verts, normals, faces):
        lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
        lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in normals]
        lines += [f"f {a + 1}//{a + 1} {b + 1}//{b + 1} {c + 1}//{c + 1}" for a, b, c in faces]
        with open(os.path.join(obj, name), "w") as f:
            f.write("# stand-in mesh, not the reference's asset\n" + "\n".join(lines) + "\n")

    unit, faces = _icosphere(bunny_subdiv)
    write("bunny.obj", unit * 0.05 + [0.0, 0.07, 0.0], unit, faces[:, ::-1])
    verts, normals, faces = _torus(0.3, 0.12, *torus_segments)
    write("Teapot3_no_vt.obj", verts + [0.0, 0.12, 0.0], normals, faces)
    return dirpath


def triangles(aspect):
    """The OBJ mesh scene (scene.cpp:481-529): a Cornell shell with a silver
    back wall, a dielectric bunny and teapot, heavy depth of field. Without
    the mesh files (the `obj` directory under `MRT_ASSETS`) the shell alone."""
    b = SceneBuilder()
    b.name = "triangles"
    _cornell_camera(b, aspect, aperture=20.0)
    red = b.lambertian(b.tex_const([0.65, 0.05, 0.05]))
    white = b.lambertian(b.tex_const([0.73, 0.73, 0.73]))
    green = b.lambertian(b.tex_const([0.12, 0.45, 0.15]))
    light = b.diffuse_light(b.tex_const([4.0, 4.0, 4.0]))
    silver = b.metal(b.tex_const([0.8, 0.8, 0.9]), 0.9)
    dia = b.dielectric(2.4)

    b.yz_rect(555, 0, 0, 555, 555, green)
    b.yz_rect(0, 555, 0, 555, 0, red)
    lamp = b.xz_rect(443, 113, 127, 432, 554, light)
    b.xz_rect(555, 0, 0, 555, 555, white)
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xy_rect(555, 0, 0, 555, 555, silver)

    asset_dir = os.environ.get("MRT_ASSETS")

    def add_mesh(fname, **kw):
        path = os.path.join(asset_dir, "obj", fname) if asset_dir else None
        if path is None or not os.path.exists(path):
            return
        for t in zip(*read_obj(path, **kw)):
            b.triangle(t[0], t[1], t[2], dia, an=t[3], bn=t[4], cn=t[5])

    add_mesh("bunny.obj", flip=True, scale=2000.0, translate=(195, -20, 280))
    # the reference asks for teapot3_no_vt.obj, which a case-sensitive file
    # system does not have (quirk SURVEY 9.6): the real file is loaded
    add_mesh("Teapot3_no_vt.obj", scale=250.0, rot_y_deg=30.0, translate=(393, 50, 108))
    b.add_light(lamp)
    b.use_sky = False
    return b.build()


_GENERATORS = [
    random_spheres, random_spheres_2, two_spheres, perlin_spheres, earth,
    cornell_box, cornell_smoke, book2_final, triangles,
]


def select_scene(scene_id: int, aspect: float):
    """scene.cpp:25-49."""
    return _GENERATORS[scene_id](aspect)
