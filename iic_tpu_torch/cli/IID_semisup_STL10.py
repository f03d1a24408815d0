"""CLI: the semi-supervised finetune of a pretrained IID+ run, on one GPU
(``iic_tpu/cli/IID_semisup_STL10.py``). Table 3 of the paper (STL10,
``examples/commands.md:72-82``) from model 650's run directory:

    python -m iic_tpu_torch.cli.IID_semisup_STL10 --model_ind 698 \\
      --old_model_ind 650 --head_lr 0.001 --trunk_lr 0.0001 \\
      --arch SupHead5 --penultimate_features --random_affine \\
      --affine_p 0.5 --cutout --cutout_p 0.5 --cutout_max_box 0.7 \\
      --num_epochs 8000

The old run is read from ``--out_root``/``--old_model_ind``. Runs on
cuda:0 and raises when there is no GPU.
"""

import argparse

from iic_tpu_torch.cli._args import _add_dataclass_args
from iic_tpu_torch.train.config import SemisupConfig
from iic_tpu_torch.train.semisup_trainer import train_semisup


def config(argv=None):
    """The script's config from its flags ``argv``."""
    args = _add_dataclass_args(argparse.ArgumentParser(),
                               SemisupConfig).parse_args(argv)
    cfg = SemisupConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in vars(args).items()})
    return cfg.finalize()


def main(argv=None, device=None):
    return train_semisup(config(argv), device=device)


if __name__ == "__main__":
    main()
