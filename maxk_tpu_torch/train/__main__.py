"""maxk_tpu_torch training CLI: full-graph node classification with MaxK
models on one torch device (CUDA unless ``--device`` says otherwise), or
row-partitioned over ``--n_devices`` ranks.

  python -m maxk_tpu_torch.train --dataset synthetic --model sage \\
      --hidden_layers 3 --hidden_dim 256 --nonlinear maxk --maxk 32 \\
      --epochs 100

  # 2 ranks in this process's children, over gloo on the CPU:
  python -m maxk_tpu_torch.train --device cpu --n_devices 2 ...
  # 4 ranks as 2 graph shards x 2 model slices (tensor parallelism):
  python -m maxk_tpu_torch.train --device cpu --n_devices 4 \\
      --model_parallel 2 ...
  # 4 ranks as 2 processes of 2, which meet at the coordinator:
  python -m maxk_tpu_torch.train --n_devices 4 --distributed \\
      --num_processes 2 --process_id 0 --coordinator host:port ...

Rank r runs on ``cuda:(local rank % cards)`` (``--device cpu``: the
CPU), over NCCL when each of a process's ranks has a card of its own and
over gloo otherwise (``parallel/mesh.py``). Rank 0 logs and writes the
checkpoints and results.
"""

from __future__ import annotations

import os
import time

import numpy as np

from maxk_tpu_torch.data.datasets import load_dataset
from maxk_tpu_torch.train.checkpoint import CheckpointManager
from maxk_tpu_torch.train.config import TrainConfig
from maxk_tpu_torch.train.logging_utils import MetricsWriter, get_logger
from maxk_tpu_torch.train.loop import Trainer


def main(argv=None):
    config = TrainConfig().parse_args(argv)
    if config.n_devices > 1:
        return launch(config)
    return run(config)


def launch(config):
    """Spawn this process's ranks of the job; returns rank 0's result
    where rank 0 is one of them."""
    from maxk_tpu_torch.parallel.launch import spawn, train_rank
    if config.distributed:
        init_method = f"tcp://{config.coordinator}"
    else:
        # One process: its ranks meet at a store of this run's own.
        store = os.path.abspath(os.path.join(config.path, "dist_store"))
        if os.path.exists(store):
            os.remove(store)
        init_method = f"file://{store}"
    results = spawn(train_rank, config.local_device_count, init_method,
                    config.device, args=(config,),
                    num_processes=config.num_processes,
                    process_id=config.process_id)
    return results[0] if config.process_id == 0 else None


def run(config, group=None):
    """Train (or evaluate) on one device, or as one rank of ``group``."""
    np.random.seed(config.seed)
    writes = group is None or group.rank == 0

    logger = get_logger(os.path.join(config.path, f"{config.dataset}.log")
                        if writes else None)
    writer = MetricsWriter(os.path.join(config.path, "tb") if writes
                           else None)
    if writes:
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

    if group is None:
        t0 = time.perf_counter()
        trainer = Trainer(config, dataset, logger=logger, writer=writer)
        logger.info(f"device={trainer.device}")
        logger.info(f"Trainer built in {time.perf_counter() - t0:.3f} s: "
                    + ", ".join(f"{name} {s:.3f} s" for name, s
                                in trainer.build_phases.items()))
    else:
        from maxk_tpu_torch.parallel.dist_train import DistTrainer
        trainer = DistTrainer(config, dataset, group, logger=logger,
                              writer=writer)
        mode = ("halo exchange" if trainer.sharded._any.halo is not None
                else "all-gather" if trainer.sharded._any.gather
                else "no exchange (no edge crosses a shard)")
        logger.info(f"distributed trainer: {group.size} ranks "
                    f"({trainer.grid.describe()}) over {group.backend}, "
                    f"rank 0 on {trainer.device}, "
                    f"{trainer.sharded.rows_per_shard} rows a shard, {mode}")

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
