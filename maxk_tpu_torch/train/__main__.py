"""maxk_tpu_torch training CLI: full-graph node classification with MaxK
models on one torch device (CUDA unless ``--device`` says otherwise).

  python -m maxk_tpu_torch.train --dataset synthetic --model sage \\
      --hidden_layers 3 --hidden_dim 256 --nonlinear maxk --maxk 32 \\
      --epochs 100
"""

from __future__ import annotations

import os

import numpy as np

from maxk_tpu_torch.data.datasets import load_dataset
from maxk_tpu_torch.train.checkpoint import CheckpointManager
from maxk_tpu_torch.train.config import TrainConfig
from maxk_tpu_torch.train.logging_utils import MetricsWriter, get_logger
from maxk_tpu_torch.train.loop import Trainer


def main(argv=None):
    config = TrainConfig().parse_args(argv)
    np.random.seed(config.seed)

    logger = get_logger(os.path.join(config.path, f"{config.dataset}.log"))
    writer = MetricsWriter(os.path.join(config.path, "tb"))
    writer.add_text("config", TrainConfig.as_markdown(config))
    TrainConfig.save_config(config)
    for k, v in sorted(vars(config).items()):
        logger.info(f"{k}={v}")

    dataset = load_dataset(config.dataset, config.data_path,
                           selfloop=config.selfloop, seed=config.seed)
    logger.info(
        f"dataset={dataset.name} V={dataset.csr.n_nodes} "
        f"E={dataset.csr.n_edges} F={dataset.in_size} "
        f"classes={dataset.num_classes} multilabel={dataset.multilabel}")

    trainer = Trainer(config, dataset, logger=logger, writer=writer)
    logger.info(f"device={trainer.device}")

    if config.evaluate:
        # Evaluate-only: restore the latest checkpoint under the given
        # experiment path and report train/val/test metrics.
        blob, step = CheckpointManager(
            os.path.join(config.evaluate, "ckpt")).restore()
        trainer.load_blob(blob)
        train_acc, val_acc, test_acc = trainer.evaluate_masks()
        logger.info(f"Evaluate-only @ epoch {step}: "
                    f"Train {train_acc:.4f} | Val {val_acc:.4f} | "
                    f"Test {test_acc:.4f}")
        writer.close()
        return dict(epoch=step, train=train_acc, val=val_acc, test=test_acc)

    logger.info("Training...")
    results = trainer.fit()

    logger.info("Testing...")
    logger.info(f"Best val accuracy {results.best_val:.4f} "
                f"(epoch {results.best_epoch})")
    logger.info(f"Best test accuracy {results.best_test:.4f}")
    logger.info(f"Test accuracy {results.final_test:.4f}")
    writer.close()
    return results


if __name__ == "__main__":
    main()
