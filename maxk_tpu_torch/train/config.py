"""Training configuration: the JAX package's flag set (reference
utils/config.py names) plus ``--device``.

Flags of paths not ported yet are accepted and refused when set:
``--n_devices`` / ``--model_parallel`` > 1 and the multi-host flags wait
for ROADMAP slice 5, ``--profile`` for a later PR.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


class TrainConfig(argparse.ArgumentParser):
    """ArgumentParser subclass, reference-compatible flag names."""

    def __init__(self):
        super().__init__(
            description="maxk_tpu_torch Training Configuration")

        # Dataset
        self.add_argument("--dataset", type=str, default="reddit",
                          choices=["reddit", "flickr", "yelp", "ogbn-arxiv",
                                   "ogbn-products", "ogbn-proteins",
                                   "synthetic"])
        self.add_argument("--data_path", type=str, default="./data/")

        # Model
        self.add_argument("--model", type=str, default="sage",
                          choices=["sage", "sage_fused", "gcn", "gin",
                                   "gnn_res"])
        self.add_argument("--hidden_dim", type=int, default=256)
        self.add_argument("--hidden_layers", type=int, default=3)
        self.add_argument("--dropout", type=float, default=0.5)
        self.add_argument("--norm", action="store_true", default=False)

        # MaxK
        self.add_argument("--nonlinear", type=str, default="maxk",
                          choices=["maxk", "relu"])
        self.add_argument("--maxk", type=int, default=32)

        # Training
        self.add_argument("--epochs", type=int, default=1000)
        self.add_argument("--patience", type=int, default=0,
                          help="Early stop after N evals without val "
                               "improvement (reference integrated driver "
                               "uses 100, maxk_gnn_integrated.py:166-209; "
                               "0 = off)")
        self.add_argument("--w_lr", type=float, default=0.01)
        self.add_argument("--w_weight_decay", type=float, default=0.0)
        self.add_argument("--enable_lookahead", action="store_true",
                          default=False)
        self.add_argument("--seed", type=int, default=97)
        self.add_argument("--selfloop", action="store_true", default=False)

        # Output
        self.add_argument("--path", type=str, default=None)
        self.add_argument("--evaluate", type=str, default=None)
        self.add_argument("--log_every", type=int, default=1,
                          help="Epoch metric-log frequency")
        self.add_argument("--eval_every", type=int, default=1,
                          help="Eval frequency (the reference DGL driver "
                               "evaluates every epoch, maxk_gnn_dgl.py:101)")
        self.add_argument("--save_every", type=int, default=500,
                          help="Checkpoint frequency in epochs (0 = off)")
        self.add_argument("--resume", action="store_true", default=False,
                          help="Resume from the latest checkpoint in --path")

        # Execution
        self.add_argument("--device", type=str, default="cuda",
                          help="torch device to train on (cuda, cuda:N, "
                               "cpu)")
        # Multi-device flags of the JAX package; only the single-device
        # values are accepted until ROADMAP slice 5.
        self.add_argument("--n_devices", type=int, default=0,
                          help="Devices in the graph mesh (0/1 only)")
        self.add_argument("--model_parallel", type=int, default=1,
                          help="Tensor-parallel size (1 only)")
        self.add_argument("--distributed", action="store_true",
                          default=False, help="Multi-host (not ported)")
        self.add_argument("--coordinator", type=str, default=None,
                          help="host:port of process 0 (not ported)")
        self.add_argument("--num_processes", type=int, default=None,
                          help="total processes in the job (not ported)")
        self.add_argument("--process_id", type=int, default=None,
                          help="this process's rank (not ported)")
        self.add_argument("--local_device_count", type=int, default=None,
                          help="virtual devices per process (not ported)")
        self.add_argument("--no_halo", dest="halo", action="store_false",
                          default=True,
                          help="Disable the halo exchange (multi-device "
                               "only; no effect here)")
        self.add_argument("--compute_dtype", type=str, default="bfloat16",
                          choices=["bfloat16", "float32"],
                          help="SpMM input dtype for x (accumulation "
                               "is fp32)")
        self.add_argument("--profile", action="store_true", default=False,
                          help="Profile trace (not ported yet)")
        self.add_argument("--timing", action="store_true", default=False,
                          help="Report per-epoch wall-clock timing")
        self.add_argument("--debug", action="store_true", default=False)

    def parse_args(self, args=None, namespace=None):
        config = super().parse_args(args, namespace)
        if config.nonlinear == "maxk" and config.maxk > config.hidden_dim:
            self.error(
                f"--maxk {config.maxk} exceeds --hidden_dim "
                f"{config.hidden_dim}: MaxK keeps k of the hidden "
                f"channels, so k must be <= hidden_dim (the reference's "
                f"torch.topk would fail the same way at the first layer)")
        unported = [
            flag for flag, on in (
                ("--n_devices > 1", config.n_devices > 1),
                ("--model_parallel > 1", config.model_parallel > 1),
                ("--distributed", config.distributed),
                ("--num_processes > 1", (config.num_processes or 0) > 1),
                ("--coordinator", config.coordinator is not None),
                ("--process_id", config.process_id is not None),
                ("--local_device_count",
                 config.local_device_count is not None),
                ("--profile", config.profile)) if on]
        if unported:
            self.error(f"{', '.join(unported)}: not ported yet "
                       f"(ROADMAP.md: multi-device is slice 5, --profile "
                       f"is queued)")
        if config.path is None:
            ts = time.strftime("%Y%m%d_%H%M%S")
            config.path = (f"experiments/{config.dataset}_{config.model}"
                           f"_maxk{config.maxk}_{ts}")
        Path(config.path).mkdir(parents=True, exist_ok=True)
        return config

    @staticmethod
    def save_config(config, filename: str = "config.json"):
        out = Path(config.path) / filename
        with open(out, "w") as f:
            json.dump(vars(config), f, indent=2, default=str)
        return out

    @staticmethod
    def as_markdown(config) -> str:
        lines = ["|name|value|", "|-|-|"]
        lines += [f"|{k}|{v}|" for k, v in sorted(vars(config).items())]
        return "\n".join(lines)

