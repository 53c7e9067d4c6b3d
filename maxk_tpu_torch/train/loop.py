"""Full-graph training loop.

Per-epoch full-graph forward, masked CE (or BCE-with-logits for
multilabel datasets), Adam (+ optional Lookahead), train/val/test
evaluation every ``eval_every`` epochs with best-val tracking, patience
early stop, checkpoint every ``save_every`` epochs and resume, and a
``final_results.json`` artifact — the JAX package's ``FitLoop`` and
``Trainer`` on one torch device. Under ``--timing`` each step is timed
with CUDA events (host clock on the CPU).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import torch
import torch.nn.functional as F

from maxk_tpu_torch.data.datasets import Dataset
from maxk_tpu_torch.models.models import GraphBundle, build_model
from maxk_tpu_torch.ops.graph import resolve_device
from maxk_tpu_torch.train import metrics as metrics_lib
from maxk_tpu_torch.train.checkpoint import CheckpointManager
from maxk_tpu_torch.train.optim import make_optimizer


@dataclasses.dataclass
class TrainResults:
    best_val: float
    best_test: float
    final_test: float
    best_epoch: int
    epochs_run: int
    history: list
    early_stopped: bool = False


def masked_loss(logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, multilabel: bool) -> torch.Tensor:
    """CE over masked nodes (single-label) or BCE-with-logits averaged
    over targets (multilabel), divided by max(sum(mask), 1)."""
    if multilabel:
        per = F.binary_cross_entropy_with_logits(
            logits, labels, reduction="none").mean(dim=-1)
    else:
        per = F.cross_entropy(logits, labels, reduction="none")
    m = mask.to(per.dtype)
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


class FitLoop:
    """The training driver: epochs, evaluation, best-val and patience,
    checkpoints and resume, timing, final_results.json.

    Implementors provide: config, logger, writer, device, epoch,
    train_step(), evaluate_masks(), state_blob(extra), load_blob(blob).
    """

    def _timed_step(self):
        """(loss, seconds or None); seconds only under --timing."""
        if not getattr(self.config, "timing", False):
            return self.train_step(), None
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = self.train_step()
            end.record()
            end.synchronize()
            return loss, start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        loss = self.train_step()
        return loss, time.perf_counter() - t0

    def fit(self) -> TrainResults:
        cfg = self.config
        ckpt = None
        best = {"val": 0.0, "test": 0.0, "epoch": -1}
        bad_evals = 0
        if getattr(cfg, "save_every", 0) or getattr(cfg, "resume", False):
            ckpt = CheckpointManager(f"{cfg.path}/ckpt")
            if getattr(cfg, "resume", False) \
                    and ckpt.latest_step() is not None:
                blob, _ = ckpt.restore()
                extra = self.load_blob(blob)
                best.update(val=extra["best_val"], test=extra["best_test"],
                            epoch=extra["best_epoch"])
                bad_evals = extra["bad_evals"]
                if self.logger:
                    self.logger.info(
                        f"Resumed from epoch {self.epoch} "
                        f"(best val {best['val']:.4f} @ {best['epoch']})")
        start_epoch = self.epoch

        patience = getattr(cfg, "patience", 0)
        history = []
        early_stopped = False
        t_start = time.time()
        epoch = start_epoch - 1
        for epoch in range(start_epoch, cfg.epochs):
            loss, step_s = self._timed_step()

            if (epoch % max(1, getattr(cfg, "eval_every", 1))) == 0 \
                    or epoch == cfg.epochs - 1:
                train_acc, val_acc, test_acc = self.evaluate_masks()
                if val_acc > best["val"]:
                    best.update(val=val_acc, test=test_acc, epoch=epoch)
                    bad_evals = 0
                else:
                    bad_evals += 1
                loss_f = float(loss)
                history.append(dict(epoch=epoch, loss=loss_f,
                                    train=train_acc, val=val_acc,
                                    test=test_acc))
                if self.writer:
                    self.writer.add_scalar("train/loss", loss_f, epoch)
                    self.writer.add_scalar("train/train_acc", train_acc,
                                           epoch)
                    self.writer.add_scalar("train/val_acc", val_acc, epoch)
                    self.writer.add_scalar("train/test_acc", test_acc, epoch)
                if self.logger and (epoch % max(1, getattr(
                        cfg, "log_every", 1)) == 0):
                    msg = (f"Epoch {epoch:04d}/{cfg.epochs:04d}| "
                           f"Loss {loss_f:.4f} | "
                           f"Train Accuracy {train_acc:.4f} | "
                           f"Val Accuracy {val_acc:.4f} | "
                           f"Test Accuracy {test_acc:.4f} | "
                           f"Best val. Accuracy {best['val']:.4f} | "
                           f"Best test Accuracy {best['test']:.4f}")
                    if step_s is not None:
                        msg += f" | step {step_s*1e3:.1f}ms"
                    self.logger.info(msg)
                if patience and bad_evals >= patience:
                    early_stopped = True
                    if self.logger:
                        self.logger.info(
                            f"Early stop at epoch {epoch}: no val "
                            f"improvement in {patience} evals "
                            f"(best {best['val']:.4f} @ {best['epoch']})")

            if ckpt and getattr(cfg, "save_every", 0) \
                    and ((epoch + 1) % cfg.save_every == 0 or early_stopped):
                ckpt.save(epoch + 1, self.state_blob(dict(
                    best_val=best["val"], best_test=best["test"],
                    best_epoch=best["epoch"], bad_evals=bad_evals)))
            if early_stopped:
                break

        _, _, final_test = self.evaluate_masks()
        if self.logger:
            total = time.time() - t_start
            self.logger.info(f"Training done in {total:.1f}s; "
                             f"final test {final_test:.4f}")
        results = TrainResults(
            best_val=best["val"], best_test=best["test"],
            final_test=final_test, best_epoch=best["epoch"],
            epochs_run=epoch + 1 - start_epoch, history=history,
            early_stopped=early_stopped)
        self._save_final_results(results)
        return results

    def _save_final_results(self, results: TrainResults) -> None:
        """Final {config, results, history} artifact, as JSON."""
        path = getattr(self.config, "path", None)
        if not path:
            return
        blob = dict(config={k: str(v) for k, v in
                            sorted(vars(self.config).items())},
                    results={k: v for k, v in
                             dataclasses.asdict(results).items()
                             if k != "history"},
                    history=results.history)
        try:
            with open(f"{path}/final_results.json", "w") as f:
                json.dump(blob, f, indent=2, default=float)
        except OSError as e:
            if self.logger:
                self.logger.warning(f"could not save final results: {e}")


class Trainer(FitLoop):
    """Model, optimizer, train step, evaluation and the fit loop."""

    def __init__(self, config, dataset: Dataset, logger=None, writer=None,
                 graphs: Optional[GraphBundle] = None, device=None):
        self.config = config
        self.dataset = dataset
        self.logger = logger
        self.writer = writer
        self.device = resolve_device(
            device if device is not None else getattr(config, "device", None))

        self.graphs = graphs if graphs is not None else \
            GraphBundle.for_model(dataset.csr, config.model,
                                  symmetric=getattr(dataset, "symmetric",
                                                    False),
                                  device=self.device)
        self.model = build_model(
            config.model, dataset.in_size, config.hidden_dim,
            config.hidden_layers, dataset.num_classes, maxk=config.maxk,
            feat_drop=config.dropout, norm=config.norm,
            nonlinear=config.nonlinear,
            compute_dtype=getattr(config, "compute_dtype", "bfloat16"),
            generator=torch.Generator().manual_seed(config.seed),
        ).to(self.device)
        self.optimizer = make_optimizer(
            self.model.parameters(), config.w_lr, config.w_weight_decay,
            enable_lookahead=getattr(config, "enable_lookahead", False))
        # Dropout bits: one generator on the device, saved in checkpoints.
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self.epoch = 0

        self.features = torch.from_numpy(dataset.features).to(self.device)
        labels = torch.from_numpy(dataset.labels)
        self.labels = labels.to(self.device)
        self.train_mask = torch.from_numpy(dataset.train_mask).to(
            self.device)

    # -- steps ----------------------------------------------------------------

    def train_step(self) -> torch.Tensor:
        """One full-graph step; returns the loss (still on the device)."""
        self.model.train()
        logits = self.model(self.graphs, self.features, training=True,
                            generator=self.generator)
        loss = masked_loss(logits, self.labels, self.train_mask,
                           self.dataset.multilabel)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.epoch += 1
        return loss.detach()

    @torch.no_grad()
    def eval_logits(self) -> torch.Tensor:
        self.model.eval()
        return self.model(self.graphs, self.features, training=False)

    def evaluate_masks(self):
        """(train, val, test) metric triple."""
        logits = self.eval_logits().float().cpu().numpy()
        ds = self.dataset
        return tuple(
            metrics_lib.evaluate_logits(logits, ds.labels, m, ds.metric)
            for m in (ds.train_mask, ds.val_mask, ds.test_mask))

    # -- checkpoints -------------------------------------------------------------

    def state_blob(self, extra: dict) -> dict:
        return dict(model=self.model.state_dict(),
                    optimizer=self.optimizer.state_dict(),
                    generator=self.generator.get_state(),
                    epoch=self.epoch, extra=extra)

    def load_blob(self, blob: dict) -> dict:
        """Restore a state_blob; returns its extra dict."""
        self.model.load_state_dict(blob["model"])
        self.optimizer.load_state_dict(blob["optimizer"])
        self.generator.set_state(blob["generator"])
        self.epoch = blob["epoch"]
        return blob["extra"]
