"""Experiment management + logging, a copy of
`efficient_nerf_tpu.utils.logging`.

Replaces the external smilelogging package the reference depends on
(Logger(args) with ExpID, Experiments/<project>_<ExpID>/{weights,gen_img,log}
directory layout, console+file logging, args/config snapshot; call sites
main.py:32-33, 962-971). `cache_code` snapshots this package's sources
(its CUDA sources too).
"""
from __future__ import annotations

import logging
import os
import socket
import sys
import time
from typing import Optional

__all__ = ["Logger"]


class Logger:
    """Experiment directory + dual console/file logger.

    Directory layout (parity with smilelogging):
        <basedir>/Experiments/<project>_<ExpID>/
            weights/   checkpoints
            gen_img/   rendered images & videos
            log/       log.txt, args snapshot
    """

    def __init__(self, args=None, project: Optional[str] = None,
                 basedir: str = ".", debug: bool = False):
        project = (project or getattr(args, "project", None)
                   or getattr(args, "expname", None) or "exp")
        ts = time.strftime("%Y%m%d-%H%M%S")
        host = socket.gethostname().split(".")[0]
        self.ExpID = f"SERVER{host}-{ts}"
        root = os.path.join(basedir, "Experiments",
                            f"{project}_{self.ExpID}" if not debug
                            else f"{project}_DEBUG")
        self.exp_path = root
        self.weights_path = os.path.join(root, "weights")
        self.gen_img_path = os.path.join(root, "gen_img")
        self.log_path = os.path.join(root, "log")
        for d in (self.weights_path, self.gen_img_path, self.log_path):
            os.makedirs(d, exist_ok=True)

        self._logger = logging.getLogger(f"entpu_torch.{root}")
        self._logger.setLevel(logging.INFO)
        self._logger.handlers.clear()
        fmt = logging.Formatter("[%(asctime)s] %(message)s",
                                datefmt="%m/%d %H:%M:%S")
        fh = logging.FileHandler(os.path.join(self.log_path, "log.txt"))
        fh.setFormatter(fmt)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        self._logger.addHandler(fh)
        self._logger.addHandler(sh)
        self._logger.propagate = False

        if args is not None:
            self.save_args(args)
            if not debug:
                self.cache_code(getattr(args, "cache_ignore", ""))

    def info(self, *msg, unprefix: bool = False, acc: bool = False):
        text = " ".join(str(m) for m in msg)
        self._logger.info(text)

    def cache_code(self, ignore: str = ""):
        """Snapshot the package source into <exp>/.caches/code for
        reproducibility (smilelogging's code-cache; reference main.py:22-33
        relies on it via `--cache_ignore`). `ignore` is a comma-separated
        list of fnmatch patterns, each matched against every PATH SEGMENT
        of a source file's relative path (so `ignore=ops` skips the ops/
        directory and ops.py, not loops.py)."""
        import fnmatch
        import shutil

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        dst_root = os.path.join(self.exp_path, ".caches", "code",
                                os.path.basename(pkg_root))
        skips = [s for s in (ignore or "").split(",") if s]

        def skipped(rel):
            parts = rel.split(os.sep)
            segs = parts + [os.path.splitext(parts[-1])[0]]
            return any(fnmatch.fnmatch(seg, pat)
                       for seg in segs for pat in skips)

        for dirpath, dirnames, filenames in os.walk(pkg_root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in filenames:
                if not fn.endswith((".py", ".cpp", ".txt", ".cu", ".cuh")):
                    continue
                src = os.path.join(dirpath, fn)
                rel = os.path.relpath(src, pkg_root)
                if skipped(rel):
                    continue
                dst = os.path.join(dst_root, rel)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copyfile(src, dst)
        self.code_cache_path = dst_root

    def save_args(self, args):
        path = os.path.join(self.log_path, "args.txt")
        with open(path, "w") as f:
            for k in sorted(vars(args)):
                f.write(f"{k} = {getattr(args, k)}\n")
        cfg = getattr(args, "config", None)
        if cfg and os.path.exists(cfg):
            with open(os.path.join(self.log_path, "config.txt"), "w") as f:
                f.write(open(cfg).read())
