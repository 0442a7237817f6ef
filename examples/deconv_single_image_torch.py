"""Tutorial: deconvolve a single galaxy stamp and measure its shear, with the
PyTorch port (counterpart of ``examples/deconv_single_image.py``).

Loads (obs, psf, gt) of the first test galaxy of a packed benchmark
dataset, builds the flagship ``Unrolled_ADMM_Gaussian(8)``, restores the
port's trained weights (a ``train_state.pt`` written by ``cli train`` or by
``scripts/trained_to_port.py``) or, when none exist, uses Richardson-Lucy
instead, reconstructs, and estimates the shear of the ground truth, the
observation and the reconstruction.

Run:  python examples/deconv_single_image_torch.py [--checkpoint saved_models --epoch 0]
          [--data_path DIR] [--device cpu]
(--epoch 0 takes the latest checkpoint of the run; without one the tutorial
uses Richardson-Lucy (30).  It runs on the card unless --device cpu.)
"""

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

RUN_NAME = "Gaussian_PnP_ADMM_8iters_MultiScale"


def load_stamp(data_path=None):
    """(obs, psf, gt) of the first test galaxy of ``data_path`` or, without
    one, of the first packed benchmark dataset found under ``datasets/``."""
    roots = [pathlib.Path(data_path)] if data_path else [pathlib.Path("datasets") / name for name in
                                                         ("LSST_23.5_deconv_tpu", "LSST_23.5_deconv_tpu_10k")]
    for root in roots:
        root = root / "test"
        if not root.exists():
            continue
        # the benchmark layout stores fixed-SNR variants (obs_100 etc.); the plain layout a single obs
        obs_file = root / "obs.npy" if (root / "obs.npy").exists() else root / "obs_100.npy"
        gt_file = root / "gt.npy" if (root / "gt.npy").exists() else root / "gt_100.npy"
        obs = np.load(obs_file, mmap_mode="r")[0].astype(np.float32)
        psf = np.load(root / "psf.npy", mmap_mode="r")[0].astype(np.float32)
        gt = np.load(gt_file, mmap_mode="r")[0].astype(np.float32)
        return obs, psf, gt
    raise SystemExit("no dataset found: run python -m galaxy_deconv_tpu_torch generate --data_path DIR ...")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", type=str, default="saved_models",
                        help="directory of the port's checkpoints (cli train's --model_save_path)")
    parser.add_argument("--epoch", type=int, default=0, help="0 = latest in --checkpoint")
    parser.add_argument("--data_path", type=str, default=None, help="a packed dataset (default: under datasets/)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from galaxy_deconv_tpu_torch.metrics import estimate_shear, psnr
    from galaxy_deconv_tpu_torch.models import build_model
    from galaxy_deconv_tpu_torch.train.checkpoint import latest_epoch, restore_checkpoint
    from galaxy_deconv_tpu_torch.utils.device import fp32_only, resolve_device

    device = resolve_device(args.device)
    obs, psf, gt = load_stamp(args.data_path)
    obs_b, psf_b, gt_b = (torch.from_numpy(a[None]).to(device) for a in (obs, psf, gt))
    alpha = obs_b.mean(dim=(1, 2))

    epoch = args.epoch or latest_epoch(args.checkpoint, RUN_NAME)
    if epoch:
        model = build_model("Unrolled_ADMM_Gaussian(8)")
        model.load_state_dict(restore_checkpoint(args.checkpoint, RUN_NAME, epoch)["model"])
        name = f"Unrolled ADMM (8), {RUN_NAME} epoch {epoch}"
    else:
        model = build_model("Richard-Lucy(30)")
        name = "Richardson-Lucy (30)"
    model = model.to(device).eval()

    with torch.inference_mode(), fp32_only():
        rec_b = model(obs_b, psf_b, alpha)
        g_gt, g_obs, g_rec = (estimate_shear(x)[0].cpu().numpy() for x in (gt_b, obs_b, rec_b))
        psnr_obs, psnr_rec = (float(psnr(x, gt_b)[0]) for x in (obs_b, rec_b))

    print(f"device: {device}")
    print(f"method: {name}")
    print(f"gt  shear: g1={g_gt[0]:+.4f} g2={g_gt[1]:+.4f} |g|={g_gt[2]:.4f}")
    print(f"obs shear: |g|={g_obs[2]:.4f}  err={abs(g_obs[2] - g_gt[2]):.4f}")
    print(f"rec shear: |g|={g_rec[2]:.4f}  err={abs(g_rec[2] - g_gt[2]):.4f}")
    print(f"psnr(obs, gt)={psnr_obs:.2f}  psnr(rec, gt)={psnr_rec:.2f}")
    return {"method": name, "rec": rec_b[0].cpu().numpy(), "g_gt": g_gt, "g_obs": g_obs, "g_rec": g_rec,
            "psnr_obs": psnr_obs, "psnr_rec": psnr_rec}


if __name__ == "__main__":
    main()
