"""COLMAP SfM preprocessing CLI — the surface of the reference's convert.py.

The counterpart of `gaussian_splatting_tpu/cli/convert.py`: shells out to
the external `colmap` (feature extraction, exhaustive matching, mapper,
undistortion) and `magick` binaries (1/2, 1/4, 1/8 resizes), mirroring
convert.py:18-124. It runs on the host alone.
"""

from __future__ import annotations

import logging
import os
import shutil
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="", type=str)
    args = parser.parse_args(argv)

    colmap_command = f'"{args.colmap_executable}"' if args.colmap_executable else "colmap"
    magick_command = f'"{args.magick_executable}"' if args.magick_executable else "magick"
    use_gpu = 1 if not args.no_gpu else 0

    if not args.skip_matching:
        os.makedirs(args.source_path + "/distorted/sparse", exist_ok=True)

        feat_extraction_cmd = (
            f"{colmap_command} feature_extractor "
            f"--database_path {args.source_path}/distorted/database.db "
            f"--image_path {args.source_path}/input "
            f"--ImageReader.single_camera 1 "
            f"--ImageReader.camera_model {args.camera} "
            f"--SiftExtraction.use_gpu {use_gpu}"
        )
        if os.system(feat_extraction_cmd):
            logging.error("Feature extraction failed. Exiting.")
            raise SystemExit(1)

        feat_matching_cmd = (
            f"{colmap_command} exhaustive_matcher "
            f"--database_path {args.source_path}/distorted/database.db "
            f"--SiftMatching.use_gpu {use_gpu}"
        )
        if os.system(feat_matching_cmd):
            logging.error("Feature matching failed. Exiting.")
            raise SystemExit(1)

        mapper_cmd = (
            f"{colmap_command} mapper "
            f"--database_path {args.source_path}/distorted/database.db "
            f"--image_path {args.source_path}/input "
            f"--output_path {args.source_path}/distorted/sparse "
            f"--Mapper.ba_global_function_tolerance=0.000001"
        )
        if os.system(mapper_cmd):
            logging.error("Mapping failed. Exiting.")
            raise SystemExit(1)

    img_undist_cmd = (
        f"{colmap_command} image_undistorter "
        f"--image_path {args.source_path}/input "
        f"--input_path {args.source_path}/distorted/sparse/0 "
        f"--output_path {args.source_path} --output_type COLMAP"
    )
    if os.system(img_undist_cmd):
        logging.error("Undistortion failed. Exiting.")
        raise SystemExit(1)

    files = os.listdir(args.source_path + "/sparse")
    os.makedirs(args.source_path + "/sparse/0", exist_ok=True)
    for file in files:
        if file == "0":
            continue
        shutil.move(
            os.path.join(args.source_path, "sparse", file),
            os.path.join(args.source_path, "sparse", "0", file),
        )

    if args.resize:
        print("Copying and resizing...")
        for pct, sub in ((50, "images_2"), (25, "images_4"), (12.5, "images_8")):
            os.makedirs(os.path.join(args.source_path, sub), exist_ok=True)
        files = os.listdir(args.source_path + "/images")
        for file in files:
            source_file = os.path.join(args.source_path, "images", file)
            for pct, sub in ((50, "images_2"), (25, "images_4"), (12.5, "images_8")):
                dest = os.path.join(args.source_path, sub, file)
                shutil.copy2(source_file, dest)
                if os.system(f"{magick_command} mogrify -resize {pct}% {dest}"):
                    logging.error(f"{pct}% resize failed. Exiting.")
                    raise SystemExit(1)

    print("Done.")


if __name__ == "__main__":
    main()
