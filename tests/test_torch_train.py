"""The port's training stack vs maxk_tpu.train, plus its own contracts.

The 20-step loss trajectory (float32 compute, dropout 0, flax params
carried across) agrees with maxk_tpu.train.loop.Trainer at rel <= 1e-4:
both run the same Adam on gradients that agree to ~1e-6. A top-k
near-tie can flip one MaxK entry once parameters have drifted by that
much: with norm off, lookahead and weight decay 5e-4 on this dataset,
step 19 meets a row whose k-th and (k+1)-th values are 5.5e-6 apart and
the losses part by 2.6e-2 (ROADMAP.md, queue 3). The cases below have no
such tie within 20 steps.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.data.datasets import make_synthetic_dataset as jax_dataset
from maxk_tpu.train import metrics as jax_metrics
from maxk_tpu.train.loop import Trainer as JaxTrainer
from maxk_tpu.train.loop import masked_loss as jax_masked_loss
from maxk_tpu.train.optim import make_optimizer as jax_make_optimizer
from maxk_tpu_torch.data.datasets import make_synthetic_dataset
from maxk_tpu_torch.train import metrics
from maxk_tpu_torch.train.__main__ import main as cli_main
from maxk_tpu_torch.train.checkpoint import CheckpointManager
from maxk_tpu_torch.train.config import TrainConfig
from maxk_tpu_torch.train.loop import Trainer, masked_loss
from maxk_tpu_torch.train.optim import make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class _Cfg:
    dataset: str = "synthetic"
    model: str = "sage"
    hidden_dim: int = 32
    hidden_layers: int = 2
    dropout: float = 0.0
    norm: bool = True
    nonlinear: str = "maxk"
    maxk: int = 8
    epochs: int = 20
    w_lr: float = 0.01
    w_weight_decay: float = 0.0
    enable_lookahead: bool = False
    seed: int = 97
    selfloop: bool = False
    path: str = ""
    log_every: int = 1000
    eval_every: int = 1
    save_every: int = 0
    resume: bool = False
    timing: bool = False
    patience: int = 0
    compute_dtype: str = "float32"
    device: str = "cpu"


def _dataset(seed=3):
    kw = dict(n_nodes=300, avg_degree=8.0, n_classes=5, in_size=24,
              seed=seed)
    return jax_dataset(**kw), make_synthetic_dataset(**kw)


@pytest.mark.parametrize("norm,lookahead,wd", [(True, False, 0.0),
                                               (True, True, 5e-4),
                                               (False, False, 5e-4)])
def test_loss_trajectory_matches_jax(tmp_path, norm, lookahead, wd):
    jax_ds, ds = _dataset()
    cfg = _Cfg(path=str(tmp_path), norm=norm, enable_lookahead=lookahead,
               w_weight_decay=wd)
    ref = JaxTrainer(cfg, jax_ds)
    state = ref.init_state()
    tr = Trainer(cfg, ds)
    tr.model.load_flax_params(jax.tree.map(np.asarray, state.params))

    ref_losses, losses = [], []
    rng = jax.random.PRNGKey(0)
    for _ in range(20):
        state, loss = ref._jit_step(state, rng)
        ref_losses.append(float(loss))
        losses.append(float(tr.train_step()))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_resume_reproduces_uninterrupted_run(tmp_path):
    _, ds = _dataset(seed=5)
    base = dict(dropout=0.3, eval_every=1, enable_lookahead=True)
    full = Trainer(_Cfg(path=str(tmp_path / "full"), epochs=8, **base),
                   ds).fit()

    os.makedirs(tmp_path / "part")
    first = _Cfg(path=str(tmp_path / "part"), epochs=5, save_every=5, **base)
    Trainer(first, ds).fit()
    resumed = Trainer(dataclasses.replace(first, epochs=8, resume=True),
                      ds).fit()
    assert resumed.epochs_run == 3
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in full.history[5:]]
    assert resumed.best_val == full.best_val
    assert resumed.final_test == full.final_test


def test_checkpoint_keeps_newest(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    for step in (1, 2, 3, 4):
        ckpt.save(step, {"step": step})
    assert ckpt.steps() == [2, 3, 4]
    blob, step = ckpt.restore()
    assert step == 4 and blob == {"step": 4}


def test_patience_early_stop(tmp_path):
    _, ds = _dataset(seed=6)
    cfg = _Cfg(path=str(tmp_path), epochs=50, w_lr=0.0, patience=1)
    res = Trainer(cfg, ds).fit()
    assert res.early_stopped and res.epochs_run <= 3


def test_final_results_artifact(tmp_path):
    _, ds = _dataset(seed=7)
    res = Trainer(_Cfg(path=str(tmp_path), epochs=2, timing=True),
                  ds).fit()
    blob = json.load(open(tmp_path / "final_results.json"))
    assert blob["results"]["best_val"] == res.best_val
    assert blob["config"]["epochs"] == "2"
    assert len(blob["history"]) == len(res.history)


@pytest.mark.parametrize("multilabel", [False, True])
def test_masked_loss_matches_jax(multilabel):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(40, 6)).astype(np.float32)
    labels = (rng.uniform(size=(40, 6)) < 0.3).astype(np.float32) \
        if multilabel else rng.integers(0, 6, 40)
    mask = rng.uniform(size=40) < 0.5
    ref = jax_masked_loss(jnp.asarray(logits), jnp.asarray(labels),
                          jnp.asarray(mask), multilabel)
    out = masked_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                      torch.from_numpy(mask), multilabel)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    empty = masked_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        torch.zeros(40, dtype=torch.bool), multilabel)
    assert float(empty) == 0.0


@pytest.mark.parametrize("metric,multilabel", [("micro_f1", False),
                                               ("micro_f1", True),
                                               ("rocauc", True)])
def test_metrics_match_jax(metric, multilabel):
    rng = np.random.default_rng(4)
    logits = np.round(rng.normal(size=(60, 7)), 1).astype(np.float32)
    labels = (rng.uniform(size=(60, 7)) < 0.4).astype(np.float32) \
        if multilabel else rng.integers(0, 7, 60)
    mask = rng.uniform(size=60) < 0.7
    ref = jax_metrics.evaluate_logits(logits, labels, mask, metric)
    out = metrics.evaluate_logits(logits, labels, mask, metric)
    assert out == ref and 0.0 < out < 1.0


def test_adam_lookahead_matches_optax():
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(13)]
    tx = jax_make_optimizer(0.05, 1e-3, enable_lookahead=True)
    p_ref = jnp.asarray(p0)
    st = tx.init(p_ref)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([p], 0.05, 1e-3, enable_lookahead=True)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, p_ref)
        p_ref = p_ref + upd
        p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_ref),
                               rtol=1e-5, atol=1e-6)


def test_cli_trains_three_epochs(tmp_path):
    res = cli_main(["--dataset", "synthetic", "--device", "cpu",
                    "--epochs", "3", "--hidden_dim", "64", "--path",
                    str(tmp_path), "--save_every", "0", "--timing"])
    assert res.epochs_run == 3 and len(res.history) == 3
    assert (tmp_path / "final_results.json").exists()
    assert (tmp_path / "synthetic.log").exists()


@pytest.mark.parametrize("flag", [["--n_devices", "2"],
                                  ["--model_parallel", "2"],
                                  ["--profile"],
                                  ["--num_processes", "2"]])
def test_cli_refuses_unported_flags(tmp_path, flag):
    with pytest.raises(SystemExit):
        TrainConfig().parse_args(["--path", str(tmp_path), *flag])


def test_trainer_without_device_or_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ds = _dataset()
    cfg = _Cfg(path=str(tmp_path))
    cfg_no_device = {k: v for k, v in vars(cfg).items() if k != "device"}
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(type("Cfg", (), cfg_no_device)(), ds)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(dataclasses.replace(cfg, device="cuda"), ds)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["--dataset", "synthetic", "--path", str(tmp_path),
                  "--epochs", "1"])


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import maxk_tpu_torch\n"
        "for m in pkgutil.walk_packages(maxk_tpu_torch.__path__,\n"
        "                               'maxk_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                              'orbax', 'maxk_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules\n"
        "                 if m.startswith('maxk_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 20
