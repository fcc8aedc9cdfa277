"""The port's trainer: the JAX package's trainer and straggler tests
(``tests/test_fault_tolerance.py``) on the port, each held to the
reference's bar, and the training launcher at smoke size on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import (StragglerMonitor, Trainer, TrainerConfig, TrainOptions,
                               init_params, make_train_step)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size steps are many tiny ops, which run fastest on one thread
    and slow down badly when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk_trainer(tmp_path, failure_hook=None, total=12):
    cfg = smoke_config("granite-8b")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), TrainOptions(grad_dtype="f32"))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))

    def init_state():
        p = init_params(cfg, device="cpu", seed=0)
        return {"params": p, "opt": init_opt_state(p)}

    tcfg = TrainerConfig(total_steps=total, checkpoint_every=4,
                         checkpoint_dir=str(tmp_path), log_every=100, max_restarts=3)
    return Trainer(tcfg, step, data, init_state, failure_hook=failure_hook,
                   log=lambda s: None)


def test_trainer_recovers_from_injected_failure(tmp_path):
    """A failure at step 6 -> restore the step-4 checkpoint -> the same
    final state as an uninterrupted run (deterministic batch replay)."""
    fired = {"done": False}

    def boom(step):
        if step == 6 and not fired["done"]:
            fired["done"] = True
            raise RuntimeError("injected device failure")

    t1 = _mk_trainer(tmp_path / "a", failure_hook=boom)
    p1, o1 = t1.run()
    assert t1.restarts == 1
    t2 = _mk_trainer(tmp_path / "b")
    p2, o2 = t2.run()
    assert p1.keys() == p2.keys() and int(o1["count"]) == int(o2["count"]) == 12
    for k in p1:
        assert p1[k].dtype == p2[k].dtype
        np.testing.assert_allclose(p1[k].float().numpy(), p2[k].float().numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_trainer_gives_up_after_max_restarts(tmp_path):
    def always_boom(step):
        raise RuntimeError("permanent failure")

    t = _mk_trainer(tmp_path, failure_hook=always_boom)
    with pytest.raises(RuntimeError, match="permanent"):
        t.run()
    assert t.restarts == 4


def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(n_hosts=4, window=5, zmax=2.0)
    for _ in range(5):
        for h in range(3):
            mon.record(h, 0.10 + 0.001 * h)
        mon.record(3, 0.50)                     # persistent straggler
    assert mon.check() == [3]


def test_straggler_monitor_single_host_spike():
    mon = StragglerMonitor(n_hosts=1, window=5, zmax=3.0)
    for _ in range(5):
        mon.record(0, 0.1)
    mon.record(0, 10.0)
    assert mon.check() == [0]


def test_launch_train_smoke_on_the_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "granite-8b", "--smoke", "--device", "cpu", "--steps", "3",
                       "--seq", "16", "--batch", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "done: loss" in out
    # --zero1 runs: with no process group the mesh is 1x1 and the run is the
    # one-device run; a larger --mesh needs torchrun (the sharded launcher
    # runs in test_torch_train_mesh.py).
    launch_train.main(["--arch", "granite-8b", "--smoke", "--device", "cpu", "--zero1",
                       "--steps", "2", "--seq", "16", "--batch", "2",
                       "--ckpt-dir", str(tmp_path / "z")])
    out = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 1}" in out and "done: loss" in out
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_train.main(["--arch", "granite-8b", "--smoke", "--device", "cpu", "--mesh",
                           "2x1", "--ckpt-dir", str(tmp_path / "m")])


def test_trainer_default_batches_land_on_the_params_device(tmp_path):
    seen = []

    def step(params, opt, batch):
        seen.append({k: (v.dtype, v.device) for k, v in batch.items()})
        return params, opt, {"loss": torch.zeros(())}

    t = Trainer(TrainerConfig(total_steps=1, checkpoint_every=10, checkpoint_dir=str(tmp_path)),
                step, SyntheticLM(DataConfig(vocab=50, seq_len=8, global_batch=2)),
                lambda: {"params": {"w": torch.zeros(3)}, "opt": {}}, log=lambda s: None)
    t.run()
    assert seen == [{"tokens": (torch.int64, torch.device("cpu")),
                     "labels": (torch.int64, torch.device("cpu"))}]
