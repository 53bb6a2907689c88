from .rays import get_rays, plucker_rays
from .sampling import linear_zvals
from .encoding import ray_embed, ray_embed_dim
from .ray_sampler import sample_image_points, sample_ray_points
from . import poses
