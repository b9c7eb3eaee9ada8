"""Train a PCRNet registration model in the PyTorch port (the reference's
train_W_COS.py run).

    python examples/train_registration_torch.py --criterion w_cos --epochs 200
    python examples/train_registration_torch.py --criterion cd --noise 0.04 --device cpu

Criteria: w_cos (flagship adversarial SHWD) | w1_cos | cd (Chamfer) |
pseudo_w_cos | sinkhorn | max_ssw. Same arguments as
``examples/train_registration.py``, plus ``--device`` (default: the card).
Checkpoints (three best families), the config, run.log and per-epoch
metrics land under log/<experiment>/. Evaluate afterwards with:

    python -m shwd_torch.train.runner eval <experiment> --log-dir log
"""

import argparse
# package import: works installed or straight from a repo checkout
try:
    import shwd_torch  # noqa: F401
except ModuleNotFoundError:
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


from shwd_torch.data import DatasetConfig, RegistrationDataset, TransformConfig
from shwd_torch.train import TrainConfig, Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--experiment", default="demo")
    ap.add_argument("--criterion", default="w_cos")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--points", type=int, default=128)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--angle-range", type=float, default=45.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--modelnet-root", default=None,
                    help="path to ModelNet10 OFF files; synthetic shape bank "
                         "if omitted")
    ap.add_argument("--num-synthetic", type=int, default=2048)
    ap.add_argument("--shapes", default="composite",
                    help="comma-separated synthetic shape classes; default "
                         "'composite' (asymmetric, pose identifiable)")
    ap.add_argument("--load-model", default=None, help="checkpoint to resume")
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu (default: the card)")
    args = ap.parse_args()

    cfg = TrainConfig(
        experiment=args.experiment,
        criterion=args.criterion,
        num_epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        seed=args.seed,
        load_model=args.load_model,
        dataset=DatasetConfig(
            source_point_num=args.points, target_point_num=args.points,
            modelnet_root=args.modelnet_root,
            num_synthetic=args.num_synthetic,
            synthetic_kinds=tuple(args.shapes.split(",")),
            transform=TransformConfig(noise_sigma=args.noise,
                                      angle_range_deg=args.angle_range)),
    )
    trainer = Trainer(cfg, device=args.device)
    dataset = RegistrationDataset(cfg.dataset, "train", device=trainer.device)
    result = trainer.fit(dataset, verbose=True)
    print("best:", result["best"])


if __name__ == "__main__":
    main()
