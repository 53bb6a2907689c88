from .pseudo import (SHARD_ROWS, ShuffleBuffer, StreamingPseudoGenerator,
                     export_pseudo_shards, make_pseudo_frame_renderer,
                     scene_pose_sampler)
from .synthetic import (CAMERA_ANGLE_X, make_forward_facing_scene,
                        make_synthetic_scene, render_sphere_frame)
from .blender import BlenderData, composite_white, load_blender_data
from .llff import LLFFData, load_llff_data, minify
from .deepvoxels import DeepVoxelsData, load_dv_data
from .convert import (FICUS_IGNORE, convert_blender_to_rays, convert_llff_to_rays,
                      donerf_ray_directions, rays_to_shards)
from .native import NativeShardReader
from .rays_dataset import RayShardDataset, ShardLoader, infinite_indices
from .images_dataset import (ImageFrameDataset, append_pseudo_frames,
                             pseudo_ratio_schedule, setup_image_datadir)
