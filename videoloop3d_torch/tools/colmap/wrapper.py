"""Subprocess wrapper around the external COLMAP executable.

Parity: reference scripts/colmaps/llffposes/colmap_wrapper.py:25-96 —
SIMPLE_PINHOLE feature extraction (optionally shared intrinsics),
exhaustive/sequential matching, single-model mapping.  The binary path
comes from --colmap_bin / $COLMAP_BIN (the reference hard-codes a
Windows path).

The port's own copy of ``videoloop3d_tpu/tools/colmap/wrapper.py``.
"""
from __future__ import annotations

import os
import subprocess


def run_colmap(scenedir, match_type, pipeline, imagedir="images",
               share_intrin=True, colmap_bin=None):
    colmap_bin = colmap_bin or os.environ.get("COLMAP_BIN", "colmap")
    log_path = os.path.join(scenedir, "colmap_output.txt")
    with open(log_path, "w") as log:
        def run(args):
            out = subprocess.check_output(args, universal_newlines=True)
            log.write(out)

        if "feature_extractor" in pipeline:
            args = [colmap_bin, "feature_extractor",
                    "--database_path", os.path.join(scenedir, "database.db"),
                    "--image_path", os.path.join(scenedir, imagedir),
                    "--ImageReader.camera_model", "SIMPLE_PINHOLE"]
            if share_intrin:
                args += ["--ImageReader.single_camera", "1"]
            run(args)

        if "matcher" in pipeline:
            run([colmap_bin, match_type,
                 "--database_path", os.path.join(scenedir, "database.db")])

        if "mapper" in pipeline:
            os.makedirs(os.path.join(scenedir, "sparse"), exist_ok=True)
            run([colmap_bin, "mapper",
                 "--database_path", os.path.join(scenedir, "database.db"),
                 "--image_path", os.path.join(scenedir, imagedir),
                 "--output_path", os.path.join(scenedir, "sparse"),
                 "--Mapper.init_min_tri_angle", "4",
                 "--Mapper.multiple_models", "0"])

        if "convert" in pipeline:
            run([colmap_bin, "model_converter",
                 "--input_path", os.path.join(scenedir, "sparse/0"),
                 "--output_path", os.path.join(scenedir, "sparse/0"),
                 "--output_type", "TXT"])
    return log_path
