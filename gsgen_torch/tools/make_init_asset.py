"""Precompute generative-init point-cloud assets.

Port of the JAX package's ``tools/make_init_asset.py``.  The init
pipeline treats text->3D priors as one-shot data (reference
utils/initialize.py semantics): clouds live at
``$GSGEN_ASSET_DIR/{point_e,shap_e}_<md5(prompt)[:16]>.npz``, the JAX
package's file names, so either package reads the other's.  This CLI runs
the port's in-process samplers (:mod:`..priors`) on ``--device`` (the
card by default) where the checkpoints exist and writes the asset, so
machines without them can train from it via ``init.type=point_e|shap_e``.

    python -m gsgen_torch.tools.make_init_asset point_e "a corgi" \\
        --base /ckpts/base40M-textvec.pt --upsample /ckpts/upsample.pt \\
        --clip /models/clip-vit-large-patch14
    python -m gsgen_torch.tools.make_init_asset shap_e "a corgi" \\
        --decoder /ckpts/transmitter.pt --text300m /ckpts/text300M.pt \\
        --clip /models/clip-vit-large-patch14
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=["point_e", "shap_e"])
    ap.add_argument("prompt")
    ap.add_argument("--base", help="point-e base40M-textvec checkpoint")
    ap.add_argument("--upsample", help="point-e upsample checkpoint")
    ap.add_argument("--decoder", help="shap-e transmitter/vector_decoder")
    ap.add_argument("--text300m", help="shap-e text300M checkpoint")
    ap.add_argument("--latent", help="shap-e precomputed latent .npy")
    ap.add_argument("--clip", help="CLIP text-encoder dir (conditioning)")
    ap.add_argument("--num-points", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import priors

    if args.kind == "point_e":
        xyz, rgb = priors.point_e_generate(
            args.prompt, num_points=args.num_points,
            base_weights=args.base, upsample_weights=args.upsample,
            clip_model_dir=args.clip, seed=args.seed, device=args.device)
    else:
        xyz, rgb = priors.shap_e_generate(
            args.prompt, num_points=args.num_points,
            decoder_weights=args.decoder,
            text_model_weights=args.text300m,
            latent_path=args.latent, clip_model_dir=args.clip,
            seed=args.seed, device=args.device)
    # the port's _asset_path takes (prompt, kind), the JAX one (kind,
    # prompt): by keyword, the file names are the JAX package's
    path = priors._asset_path(prompt=args.prompt, kind=args.kind)
    print(f"wrote {path}  ({xyz.shape[0]} points)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
