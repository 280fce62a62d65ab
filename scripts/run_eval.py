"""Front-end A/B/C evaluation harness — CSV-format parity with the
reference's test/feature_test.cpp (C15).

Two modes:
  * file mode:   run_eval.py <left> <right_<roll>_<pitch>_<yaw>.ext>
                 (GT encoded in the right image filename, reference style)
  * synth mode:  run_eval.py --synth --euler R,P,Y [--size HxW] [--seed N]

Writes per-frontend CSV rows to test_result/<name>.txt:
  roll,pitch,yaw,matches,outliers,outlier%,total_keys,mean_diff
(feature_test.cpp:110-121) plus annotated overlay images.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("images", nargs="*", help="left right (GT in right filename)")
    ap.add_argument("--synth", action="store_true")
    ap.add_argument("--euler", default="2,-3,5", help="GT roll,pitch,yaw deg (synth)")
    ap.add_argument("--size", default="128x256")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out-dir", default="test_result")
    ap.add_argument("--max-keypoints", type=int, default=256)
    ap.add_argument("--ratio-thresh", type=float, default=0.5)
    ap.add_argument("--cube-size", type=int, default=0, help="0 = H//2")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from spherical_ba.core import rotation, sphere
    from spherical_ba.models import evaluation
    from spherical_ba.models.frontend import FRONTENDS
    from spherical_ba.utils import io, synthetic, viz
    from spherical_ba.utils.config import (
        FrontendConfig,
        MatchConfig,
        PipelineConfig,
        SurfConfig,
    )

    if args.synth:
        euler_deg = [float(x) for x in args.euler.split(",")]
        h, w = (int(x) for x in args.size.split("x"))
        left, right, R_gt = synthetic.rotation_pair(
            jax.random.PRNGKey(args.seed), np.deg2rad(euler_deg), h, w
        )
        name = f"synth_{args.euler}"
    else:
        left_path, right_path = args.images
        left = jnp.asarray(io.load_image(left_path))
        right = jnp.asarray(io.load_image(right_path))
        # parse GT from "..._roll_pitch_yaw.ext" (feature_test.cpp:146-163)
        stem = os.path.splitext(os.path.basename(right_path))[0]
        parts = stem.split("_")
        euler_deg = [float(p) for p in parts[1:4]]
        R_gt = rotation.euler_to_matrix(jnp.asarray(np.deg2rad(euler_deg), jnp.float32))
        name = os.path.basename(left_path)
        h, w = left.shape[0], left.shape[1]

    cube = args.cube_size or max(h // 2, 64)
    cfg = PipelineConfig(
        surf=SurfConfig(max_keypoints=args.max_keypoints, n_octaves=3),
        match=MatchConfig(ratio_thresh=args.ratio_thresh, max_matches=2 * args.max_keypoints),
        frontend=FrontendConfig(cube_size=cube),
    )

    os.makedirs(args.out_dir, exist_ok=True)
    suffix = {"erp": "fm", "band": "ss", "cubemap": "es"}
    for fe_name, fn in FRONTENDS.items():
        fr = fn(left, right, cfg)
        m = evaluation.evaluate_matches(fr, R_gt, w, h, cfg)
        row = (
            f"{euler_deg[0]},{euler_deg[1]},{euler_deg[2]},"
            f"{int(m.num_matches)},{int(m.num_outliers)},"
            f"{float(m.outlier_pct):.4f},{int(m.total_keypoints)},"
            f"{float(m.trimmed_mean_err_rad):.6f}"
        )
        log = os.path.join(args.out_dir, f"{name}_{suffix[fe_name]}.txt")
        with open(log, "a") as f:
            f.write(row + "\n")
        print(f"{fe_name}: {row}")

        # annotated overlay: GT-rotated left keypoints vs matched right
        b_l = sphere.pixel_to_bearing(fr.left_xy, w, h)
        b_r = sphere.pixel_to_bearing(fr.right_xy, w, h)
        b_rot = b_l @ jnp.asarray(R_gt).T
        lxy_rot = sphere.bearing_to_pixel(b_rot, w, h)
        diffs = sphere.angular_distance(b_rot, b_r)
        img = viz.draw_eval_overlay(
            right, np.asarray(lxy_rot), np.asarray(fr.right_xy),
            np.asarray(diffs), cfg.eval_inlier_thresh_rad,
            np.asarray(fr.match_valid),
        )
        viz.save_image(
            img,
            os.path.join(
                args.out_dir,
                f"{name}_{suffix[fe_name]}_{euler_deg[0]},{euler_deg[1]},{euler_deg[2]}.jpg",
            ),
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
