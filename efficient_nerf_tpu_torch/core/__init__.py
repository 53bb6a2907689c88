from .rays import (apply_trans_origin, get_rays, get_rays_np, ndc_rays,
                   pixel_dirs, plucker_rays, translate_origin_fixed,
                   translate_origin_to_sphere)
from .sampling import (linear_zvals, merge_sorted, sample_pdf, sorted_uniform,
                       stratified_sample, stratify_zvals)
from .encoding import nerf_embed, nerf_embed_dim, ray_embed, ray_embed_dim
from .ray_sampler import sample_image_points, sample_patch_points, sample_ray_points
from .volume import RenderOutputs, exclusive_cumprod, raw2outputs, raw2outputs_cm
from . import poses
from .poses import (make_llff_pose_sampler, novel_pose_grid, pose_spherical,
                    random_spherical_pose, recenter_poses, render_path_spiral,
                    spherical_render_poses, spherify_poses)
