"""Tiny sizes of the cells for the CPU tests: the same code paths, the
program's plain versions in float32 with exact embeds."""
R2L = {"input_dim": 60, "depth": 6, "width": 32, "n_block": 2, "n_sample": 4, "multires": 2,
       "dtype": "float32",
       "train": {"lrate": 5e-4, "lrate_decay": 500, "warmup_lr": [1e-4, 200],
                 "betas": [0.9, 0.999], "eps": 1e-8, "perturb": True, "fast_embed": False}}
NERF = {"depth": 3, "width": 32, "skips": [1], "input_ch": 15, "input_ch_views": 9,
        "multires": 2, "multires_views": 1, "n_samples": 8, "n_importance": 8, "chunk": 64,
        "train": {"lrate": 5e-4, "lrate_decay": 500, "betas": [0.9, 0.999], "eps": 1e-8,
                  "perturb": True, "fast_embed": False}}
OVERRIDES = {
    "r2l_serve": {"config": R2L, "traffic": {"H": 8, "W": 8, "warmup_frames": 1,
                                             "check_frames": 2}},
    "r2l_serve_int8": {"config": R2L, "traffic": {"H": 8, "W": 8, "warmup_frames": 1,
                                                  "check_frames": 2}},
    "r2l_distill": {"config": R2L, "traffic": {"shards": 8, "shard_rows": 64,
                                               "shards_per_batch": 2, "H": 8, "W": 8}},
    "teacher_train": {"config": NERF, "traffic": {"H": 8, "W": 8, "frames": 3, "N_rand": 16}},
}
