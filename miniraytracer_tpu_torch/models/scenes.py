"""The built-in scenes of the fused class (scene.cpp:206-383), compiled to
SceneData tables exactly as `miniraytracer_tpu/models/scenes.py` builds them.

The other five scenes (random_spheres, random_spheres_2, earth, book2_final,
triangles) need renderers that are not ported yet; `select_scene` raises for
them.
"""

from __future__ import annotations

import numpy as np

from miniraytracer_tpu_torch.scene.builder import SceneBuilder

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


_GENERATORS = {
    SCENE_TWO_SPHERES: two_spheres,
    SCENE_PERLIN_SPHERES: perlin_spheres,
    SCENE_CORNELL_BOX: cornell_box,
    SCENE_CORNELL_SMOKE: cornell_smoke,
}


def select_scene(scene_id: int, aspect: float):
    """scene.cpp:25-49, for the scenes the port has."""
    if scene_id not in _GENERATORS:
        raise NotImplementedError(
            f"scene {SCENE_NAMES[scene_id]!r} is not ported yet: it needs a "
            f"renderer outside the fused class (see ROADMAP.md queue A)")
    return _GENERATORS[scene_id](aspect)
