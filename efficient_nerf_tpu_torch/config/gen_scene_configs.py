"""Generate the per-scene config files, a copy of
`efficient_nerf_tpu.config.gen_scene_configs`.

Covers the reference's 57 configs/*.txt: 8 blender scenes (base / _noview /
_800x800 / _noview_800x800), 8 LLFF scenes (base / _noview), 6 DONeRF
scenes (_noview), lego_usebatching, and the two yenchenlin variants. The
files it writes are byte for byte the JAX package's (its header included),
which both drivers read from `options.SCENES_DIR`; this copy writes only
into the directory it is given:
`python -m efficient_nerf_tpu_torch.config.gen_scene_configs <outdir>`.
"""
from __future__ import annotations

import os
import sys

BLENDER = ["chair", "drums", "ficus", "hotdog", "lego", "materials", "mic",
           "ship"]
LLFF = ["fern", "flower", "fortress", "horns", "leaves", "orchids", "room",
        "trex"]
DONERF = ["barbershop", "bulldozer", "classroom", "forest", "pavillon",
          "sanmiguel"]

HEADER = "# generated by efficient_nerf_tpu.config.gen_scene_configs\n"


def _fmt(d):
    return HEADER + "".join(f"{k} = {v}\n" for k, v in d.items())


def blender_cfg(scene, noview=False, res800=False, datadir=None,
                white_bkgd=True):
    return {
        "expname": f"blender_paper_{scene}",
        "basedir": "./logs",
        "datadir": datadir or f"./data/nerf_synthetic/{scene}",
        "dataset_type": "blender",
        "no_batching": True,
        "use_viewdirs": not noview,
        "white_bkgd": white_bkgd,
        "lrate_decay": 500,
        "N_samples": 64,
        "N_importance": 128,
        "N_rand": 1024,
        "precrop_iters": 500,
        "precrop_frac": 0.5,
        "half_res": not res800,
    }


def llff_cfg(scene, noview=False):
    d = {
        "expname": f"{scene}_test",
        "basedir": "./logs",
        "datadir": f"./data/nerf_llff_data/{scene}",
        "dataset_type": "llff",
        "factor": 8,
        "llffhold": 8,
        "N_rand": 1024,
        "N_samples": 64,
        "N_importance": 64,
        "use_viewdirs": not noview,
        "raw_noise_std": "1e0",
    }
    # reference: base LLFF configs train BATCHED (no no_batching key,
    # configs/fern.txt); only the _noview variants pin no_batching = True
    # (configs/fern_noview.txt).
    if noview:
        d["no_batching"] = True
    return d


def donerf_cfg(scene):
    d = blender_cfg(scene, noview=True, white_bkgd=False,
                    datadir=f"./data/donerf_data/{scene}")
    d["expname"] = f"donerf_paper_{scene}"
    return d


def generate(outdir: str) -> int:
    os.makedirs(outdir, exist_ok=True)
    files = {}
    for s in BLENDER:
        files[f"{s}.txt"] = blender_cfg(s)
        files[f"{s}_noview.txt"] = blender_cfg(s, noview=True)
        files[f"{s}_800x800.txt"] = blender_cfg(s, res800=True)
        files[f"{s}_noview_800x800.txt"] = blender_cfg(s, noview=True,
                                                       res800=True)
    for s in LLFF:
        files[f"{s}.txt"] = llff_cfg(s)
        files[f"{s}_noview.txt"] = llff_cfg(s, noview=True)
    for s in DONERF:
        files[f"donerf_{s}_noview.txt"] = donerf_cfg(s)

    lego_ub = blender_cfg("lego")
    lego_ub["no_batching"] = False
    files["lego_usebatching.txt"] = lego_ub
    for s in ("hotdog", "materials"):
        c = blender_cfg(s)
        c["datadir"] = f"./data/nerf_synthetic_yenchenlin/{s}"
        files[f"{s}_yenchenlin.txt"] = c

    for name, cfg in files.items():
        with open(os.path.join(outdir, name), "w") as f:
            f.write(_fmt(cfg))
    return len(files)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: python -m efficient_nerf_tpu_torch.config."
                         "gen_scene_configs <outdir>")
    n = generate(sys.argv[1])
    print(f"wrote {n} scene configs to {sys.argv[1]}")
