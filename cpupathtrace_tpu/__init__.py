"""cpupathtrace_tpu — a differentiable Monte Carlo path tracer in JAX.

A from-scratch JAX rebuild with the capabilities of the C++
reference `johannesschaeufele/CPUPathTrace`: unbiased path tracing with
importance-sampled BSDFs and next-event estimation, BVH-accelerated triangle
and sphere geometry, OBJ meshes, thin-lens cameras with shaped apertures,
adaptive sampling, histogram tone mapping, and PNG I/O — plus capabilities the
reference lacks: differentiable rendering (unbiased pixel gradients w.r.t.
material albedo/specular/emission) and multi-chip SPMD scaling over a
`jax.sharding.Mesh`.
"""
from .core.config import RenderOptions
from .core.rays import Rays
from .camera.camera import (
    APERTURE_CIRCULAR,
    APERTURE_HEXAGONAL,
    APERTURE_NONE,
    Camera,
    make_camera,
    shoot_rays,
)
from .scene.scene import (
    BSDF_GLASS,
    BSDF_LAMBERTIAN,
    BSDF_MIRROR,
    Material,
    SceneBuilder,
    SceneData,
)
from .scene.geometry import (
    HostTriangle,
    TriangleBatch,
    make_box,
    make_plane,
    transform_triangles,
)
from .scene.mesh import load_mesh
from .integrator.film import render, render_chunk, render_tile
from .integrator.wavefront import trace
from .post import gamma_correct, post_process, tone_map
from .utils.image_io import read_rgb_image, write_rgb_image
from .integrator.checkpoint import render_resumable

__version__ = "0.1.0"

__all__ = [
    "RenderOptions", "Rays", "Camera", "make_camera", "shoot_rays",
    "APERTURE_NONE", "APERTURE_CIRCULAR", "APERTURE_HEXAGONAL",
    "Material", "SceneBuilder", "SceneData",
    "BSDF_LAMBERTIAN", "BSDF_GLASS", "BSDF_MIRROR",
    "HostTriangle", "TriangleBatch", "make_plane", "make_box",
    "transform_triangles",
    "load_mesh",
    "render", "render_chunk", "render_tile", "trace",
    "tone_map", "gamma_correct", "post_process",
    "read_rgb_image", "write_rgb_image",
    "render_resumable",
]
