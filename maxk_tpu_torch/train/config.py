"""Training configuration: the JAX package's flag set (reference
utils/config.py names) plus ``--device``.

``--n_devices N`` > 1 trains row-partitioned over N ranks
(``maxk_tpu_torch/parallel/``): one process spawns
``--local_device_count`` of them (default N), and with ``--distributed``
``--num_processes`` such processes meet at ``--coordinator``, process
``--process_id`` holding ranks ``process_id * local_device_count`` on.
``--no_halo`` all-gathers the operand instead of the halo exchange.
``--model_parallel M`` > 1 makes the N ranks a (N/M graph x M model)
grid, every Dense layer column-parallel over the model axis
(``parallel/tensor.py``), as the JAX flag does; N must be divisible by M.
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
        # Row-partitioned training over several ranks.
        self.add_argument("--n_devices", type=int, default=0,
                          help="Ranks of the graph axis, the job's world "
                               "size (0/1: one device, no process group)")
        self.add_argument("--model_parallel", type=int, default=1,
                          help="Tensor-parallel size M: the --n_devices "
                               "ranks form an (n_devices/M graph x M "
                               "model) grid, every Dense layer's columns "
                               "split over the M model ranks")
        self.add_argument("--distributed", action="store_true",
                          default=False,
                          help="Several processes, which meet at "
                               "--coordinator")
        self.add_argument("--coordinator", type=str, default=None,
                          help="host:port where the processes meet "
                               "(--distributed)")
        self.add_argument("--num_processes", type=int, default=None,
                          help="Processes in the job (--distributed; "
                               "default 1)")
        self.add_argument("--process_id", type=int, default=None,
                          help="This process's index, 0 .. "
                               "num_processes-1 (--distributed)")
        self.add_argument("--local_device_count", type=int, default=None,
                          help="Ranks this process spawns (default "
                               "n_devices / num_processes)")
        self.add_argument("--no_halo", dest="halo", action="store_false",
                          default=True,
                          help="All-gather every rank's rows for each "
                               "aggregation instead of the halo exchange")
        self.add_argument("--compute_dtype", type=str, default="bfloat16",
                          choices=["bfloat16", "float32"],
                          help="SpMM input dtype for x (accumulation "
                               "is fp32)")
        self.add_argument("--profile", action="store_true", default=False,
                          help="torch.profiler trace (CPU, and CUDA on a "
                               "CUDA device) of the post-warm-up epochs "
                               "start+1 .. start+3 into {path}/profile")
        self.add_argument("--timing", action="store_true", default=False,
                          help="Time each train step (CUDA events on a CUDA "
                               "device: the host waits for every step) and "
                               "log it on the epoch's line")
        self.add_argument("--debug", action="store_true", default=False)

    def parse_args(self, args=None, namespace=None):
        config = super().parse_args(args, namespace)
        if config.nonlinear == "maxk" and config.maxk > config.hidden_dim:
            self.error(
                f"--maxk {config.maxk} exceeds --hidden_dim "
                f"{config.hidden_dim}: MaxK keeps k of the hidden "
                f"channels, so k must be <= hidden_dim (the reference's "
                f"torch.topk would fail the same way at the first layer)")
        if config.model_parallel < 1 or (
                max(1, config.n_devices) % config.model_parallel):
            self.error(f"--n_devices={config.n_devices} not divisible by "
                       f"model_axis_size={config.model_parallel} "
                       f"(--model_parallel)")
        self._check_layout(config)
        if config.path is None:
            ts = time.strftime("%Y%m%d_%H%M%S")
            config.path = (f"experiments/{config.dataset}_{config.model}"
                           f"_maxk{config.maxk}_{ts}")
        Path(config.path).mkdir(parents=True, exist_ok=True)
        return config

    def _check_layout(self, config) -> None:
        """Fill in and check the split of --n_devices ranks over
        processes."""
        if config.distributed:
            missing = [f for f, v in (
                ("--coordinator", config.coordinator),
                ("--num_processes", config.num_processes),
                ("--process_id", config.process_id)) if v is None]
            if missing or config.n_devices < 2:
                self.error(f"--distributed needs --n_devices > 1"
                           f"{' and ' + ', '.join(missing) if missing else ''}")
        else:
            stray = [f for f, on in (
                ("--coordinator", config.coordinator is not None),
                ("--num_processes > 1", (config.num_processes or 1) > 1),
                ("--process_id > 0", (config.process_id or 0) > 0)) if on]
            if stray:
                self.error(f"{', '.join(stray)}: only with --distributed")
        config.num_processes = config.num_processes or 1
        config.process_id = config.process_id or 0
        if not 0 <= config.process_id < config.num_processes:
            self.error(f"--process_id {config.process_id} is not in "
                       f"0..{config.num_processes - 1}")
        if config.local_device_count is None:
            config.local_device_count = max(
                1, config.n_devices // config.num_processes)
        if config.n_devices > 1 and (config.local_device_count
                                     * config.num_processes
                                     != config.n_devices):
            self.error(f"--n_devices {config.n_devices} is not "
                       f"--num_processes {config.num_processes} x "
                       f"--local_device_count {config.local_device_count}")

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

