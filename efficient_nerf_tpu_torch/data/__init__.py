from .pseudo import (SHARD_ROWS, ShuffleBuffer, StreamingPseudoGenerator,
                     export_pseudo_shards, make_pseudo_frame_renderer,
                     scene_pose_sampler)
