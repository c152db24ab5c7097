"""FID between two npz image sets (the counterpart of ``scripts/eval_fid.py``):

    # model-space FID with the trained encoder as the feature extractor
    python -m ladder_tpu_torch.eval_fid real.npz generated.npz \\
        --network encoder --config codes/mnist_digit_config.json \\
        [--checkpoint-dir DIR] [--device cuda|cpu]
    python -m ladder_tpu_torch.eval_fid a.npz b.npz --network encoder \\
        --config ... --second-set original

npz files hold images under ``--key`` ('sampled_images', what the quality
record and the trainer's generation path write); the first set is treated
as original data (/255 then [-1,1]), the second as generated ([0,1]-clipped
then [-1,1]) unless ``--second-set original`` (utils/fid.py). The
``inception`` and ``VGG`` networks need ImageNet weights that the
repository does not hold and raise. ``--device`` is cuda unless the caller
asks for the CPU.

Prints one JSON line {"fid", "network", "pooling", "second_set", "files"}.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="FID between two npz image sets")
    ap.add_argument("data_file1", help="npz with 'sampled_images' (original)")
    ap.add_argument("data_file2", help="npz with 'sampled_images'")
    ap.add_argument("--network", default="inception",
                    choices=["inception", "VGG", "encoder"],
                    help="feature extractor: ImageNet InceptionV3/VGG16 "
                         "(weights not in the repository: raises) or the "
                         "trained LaDDer encoder (--config)")
    ap.add_argument("--pooling", default="avg", choices=["avg", "max"],
                    help="global pooling of the extractor features")
    ap.add_argument("--second-set", default="generated",
                    choices=["generated", "original"],
                    help="preprocessing for the second set")
    ap.add_argument("--key", default="sampled_images",
                    help="npz array key (default: sampled_images)")
    ap.add_argument("--resize-to", type=int, default=64,
                    help="common resize before feature extraction")
    ap.add_argument("--feature-size", type=int, default=140,
                    help="inception input resize")
    ap.add_argument("-c", "--config", default=None,
                    help="training config JSON (required for "
                         "--network encoder)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint dir override for --network encoder")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ladder_tpu_torch.utils.fid import compute_FID_score, encoder_feature_fn

    feature_fn = None
    if args.network == "encoder":
        if args.config is None:
            ap.error("--network encoder requires --config")
        from ladder_tpu_torch.utils.config import process_config
        cfg = process_config(args.config)
        feature_fn = encoder_feature_fn(
            cfg, checkpoint_dir=args.checkpoint_dir, device=args.device)

    score = compute_FID_score(
        args.data_file1, args.data_file2, feature_fn=feature_fn,
        second_set=args.second_set, key=args.key, resize_to=args.resize_to,
        feature_size=args.feature_size, network=args.network,
        pooling=args.pooling)
    print(json.dumps({
        "fid": score, "network": args.network, "pooling": args.pooling,
        "second_set": args.second_set,
        "files": [args.data_file1, args.data_file2],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
