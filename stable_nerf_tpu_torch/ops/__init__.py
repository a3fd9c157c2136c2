"""Ray and sample operations of the NeRF (counterpart of stable_nerf_tpu/ops)."""

from .ray_ops import near_far_from_aabb, sph_from_ray
from .morton import morton3d, morton3d_invert, packbits, unpackbits
from .composite import composite_rays
from .marching import march_rays_lattice, occupancy_lookup
from .ssim import ssim

__all__ = [
    "near_far_from_aabb",
    "sph_from_ray",
    "morton3d",
    "morton3d_invert",
    "packbits",
    "unpackbits",
    "composite_rays",
    "march_rays_lattice",
    "occupancy_lookup",
    "ssim",
]
