"""The port stands alone and runs on the card by default.

* ``repro_torch`` (every module) and ``chip_smoke.py`` import with ``jax``
  and ``repro`` blocked, and no import statement names either;
* the entry points (``train_loop`` with and without ``sim=``,
  ``async_train_loop``, ``make_train_step``, ``make_async_step``,
  ``python -m repro_torch.launch.train`` with and without the simulator
  flags and with the text families' ``--arch``, ``p2p_dgd_run``,
  ``estimate_alpha_f``, ``estimate_delta_c``) raise on a host without
  CUDA unless the caller asks for the CPU — and with ``device="cpu"``
  they run.
"""
import ast
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.aggregators import make_spec
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw, constant
from repro_torch.simulator import (Straggler, SimConfig, async_train_loop,
                                   make_async_step)
from repro_torch.training import ByzantineConfig, make_train_step, train_loop

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_no_import_names_jax_or_repro():
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, pkgutil, importlib, runpy\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "for info in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "runpy.run_path(sys.argv[1], run_name='not_main')\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code,
                          str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


FAMILY_MODULES = ["repro_torch.models.ssm", "repro_torch.models.moe",
                  "repro_torch.models.transformer",
                  "repro_torch.configs.mamba2_130m",
                  "repro_torch.configs.mixtral_8x22b",
                  "repro_torch.configs.llama4_scout_17b_a16e",
                  "repro_torch.configs.zamba2_7b",
                  "repro_torch.configs.h2o_danube_3_4b",
                  "repro_torch.configs.llama3_8b",
                  "repro_torch.configs.phi4_mini_3_8b",
                  "repro_torch.configs.internlm2_20b"]


def test_family_modules_import_and_run_with_jax_and_repro_blocked():
    """The text families' modules (ROADMAP.md item 22a) import with jax and
    repro blocked, and a mamba2 / mixtral / zamba2 smoke forward runs
    there."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {FAMILY_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import init_params, loss_fn\n"
        "for arch in ('mamba2-130m', 'mixtral-8x22b', 'zamba2-7b'):\n"
        "    cfg = get_config(arch + '-smoke')\n"
        "    p = init_params(cfg, torch.Generator().manual_seed(0))\n"
        "    t = torch.zeros(1, 8, dtype=torch.long)\n"
        "    assert torch.isfinite(loss_fn(cfg, p, {'tokens': t, "
        "'labels': t}))\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _smoke_setup(n=4, f=1, rule="coordinate_median"):
    cfg = get_config("paper-100m-smoke")
    ds = SyntheticLM(cfg.vocab_size, 16, n, 1)
    bz = ByzantineConfig(n_agents=n, f=f,
                         aggregator=make_spec(rule, f=f, n=n),
                         attack="sign_flip")
    return cfg, ds, bz, adamw(constant(1e-3))


STRAGGLERS = SimConfig(faults=(Straggler("lognormal", 0.8),), quorum=3,
                       max_staleness=3, seed=0)
SIM_FLAGS = [[], ["--quorum", "3"],
             ["--sample-policy", "uniform", "--sample-m", "3",
              "--elastic-buckets", "2", "--poison-labels"]]


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, ds, bz, opt = _smoke_setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop(cfg, bz, opt, ds, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop(cfg, bz, opt, ds, steps=1, sim=STRAGGLERS)
    with pytest.raises(RuntimeError, match="CUDA"):
        async_train_loop(cfg, bz, opt, ds, steps=1, sim=STRAGGLERS)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, bz, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_async_step(cfg, bz, opt)
    for flags in SIM_FLAGS:
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.main(["--smoke", "--steps", "1"] + flags)
    for arch in ("mamba2-130m", "mixtral-8x22b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.main(["--arch", arch, "--smoke", "--steps", "1"])


@pytest.mark.parametrize("rule", ["coordinate_median", "trimmed_mean",
                                  "krum"])
def test_async_loop_runs_on_cpu_when_asked(rule):
    """train_loop(sim=stragglers) takes the async path (quorum 3 of 4)."""
    cfg, ds, bz, opt = _smoke_setup(rule=rule)
    params, hist = train_loop(cfg, bz, opt, ds, steps=3, device="cpu",
                              sim=STRAGGLERS, log_every=1,
                              log_fn=lambda *_: None)
    assert [h["arrived"] for h in hist] == [3, 3, 3]
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert next(iter(params.values())).device.type == "cpu"


@pytest.mark.parametrize("flags", SIM_FLAGS[1:])
def test_cli_simulator_flags_run_on_cpu_when_asked(flags, capsys):
    hist = launch_train.main(["--smoke", "--device", "cpu", "--steps", "2",
                              "--n-agents", "4", "--f", "1", "--filter",
                              "trimmed_mean", "--attack", "sign_flip",
                              "--seq-len", "16", "--per-agent-batch", "1"]
                             + flags)
    assert math.isfinite(hist[-1]["loss"])
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("rule", ["coordinate_median", "trimmed_mean",
                                  "krum", "cge", "multi_krum", "m_krum",
                                  "mda", "bulyan"])
def test_train_loop_runs_on_cpu_when_asked(rule):
    cfg, ds, bz, opt = _smoke_setup(rule=rule)
    logs = []
    params, hist = train_loop(cfg, bz, opt, ds, steps=2, device="cpu",
                              log_fn=logs.append)
    assert len(hist) == 2 and len(logs) == 2
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert next(iter(params.values())).device.type == "cpu"


def test_cli_runs_on_cpu_when_asked(capsys):
    hist = launch_train.main(["--smoke", "--device", "cpu", "--steps", "2",
                              "--n-agents", "4", "--f", "1", "--filter",
                              "krum", "--attack", "sign_flip",
                              "--momentum-alpha", "0.1", "--seq-len", "16",
                              "--per-agent-batch", "1"])
    assert math.isfinite(hist[-1]["loss"])
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-130m", "mixtral-8x22b",
                                  "zamba2-7b"])
def test_cli_runs_the_text_families_on_cpu_when_asked(arch, capsys):
    """``--arch <family> --smoke`` through the launcher: the SSM's mixed
    bf16 / fp32 tree on the fp32 arena, the MoE aux in the loss, the
    hybrid's shared block; sync, then async (quorum 3 of 4)."""
    for extra in ([], ["--quorum", "3"]):
        hist = launch_train.main(
            ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
             "--n-agents", "4", "--f", "1", "--filter", "trimmed_mean",
             "--attack", "sign_flip", "--seq-len", "16",
             "--per-agent-batch", "1"] + extra)
        assert math.isfinite(hist[-1]["loss"])
        assert "final loss" in capsys.readouterr().out


def test_cli_runs_bulyan_on_cpu_when_asked(capsys):
    """The selection family through the launcher at its registered
    defaults: bulyan at n = 11, f = 2 (n >= 4f + 3)."""
    hist = launch_train.main(["--smoke", "--device", "cpu", "--steps", "2",
                              "--n-agents", "11", "--f", "2", "--filter",
                              "bulyan", "--attack", "sign_flip",
                              "--seq-len", "16", "--per-agent-batch", "1"])
    assert math.isfinite(hist[-1]["loss"])
    assert "final loss" in capsys.readouterr().out


def test_unported_options_raise_and_name_the_roadmap():
    cfg, ds, bz, opt = _smoke_setup()
    import dataclasses
    for kw in ({"reshard": True}, {"group_size": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_train_step(cfg, dataclasses.replace(bz, **kw), opt,
                            device="cpu")
    # gradient coding is ported: the step builds; a group size that does
    # not divide the agent count fails when the config is made
    make_train_step(cfg, dataclasses.replace(bz, draco_r=2), opt,
                    device="cpu")
    with pytest.raises(ValueError, match="n=4, r=3"):
        dataclasses.replace(bz, draco_r=3)
    # the sync step refuses what only the async loop's state thread runs,
    # in the JAX step's words
    with pytest.raises(NotImplementedError, match="defense-aware"):
        make_train_step(cfg, dataclasses.replace(bz, attack="spec_alie"),
                        opt, device="cpu")
    stateful = dataclasses.replace(bz, aggregator=make_spec(
        "centered_clip", f=1, n=4))
    with pytest.raises(NotImplementedError,
                       match="stateful — run it through the async loop"):
        make_train_step(cfg, stateful, opt, device="cpu")


def test_memory_defense_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, ds, bz, opt = _smoke_setup()
    import dataclasses
    bz = dataclasses.replace(bz, attack="min_max", aggregator=make_spec(
        "centered_clip", f=1, n=4, impl="kernel"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop(cfg, bz, opt, ds, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_async_step(cfg, bz, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--smoke", "--steps", "1", "--filter",
                           "zeno_pp", "--attack", "slow_drift"])


@pytest.mark.parametrize("flags", [
    ["--filter", "centered_clip", "--impl", "kernel", "--attack",
     "spec_alie"],
    ["--filter", "centered_clip", "--attack", "min_max", "--quorum", "3"],
    ["--filter", "zeno_pp", "--attack", "slow_drift"]])
def test_cli_runs_memory_defenses_on_cpu_when_asked(flags, capsys):
    hist = launch_train.main(["--smoke", "--device", "cpu", "--steps", "2",
                              "--n-agents", "4", "--f", "1", "--seq-len",
                              "16", "--per-agent-batch", "1"] + flags)
    assert math.isfinite(hist[-1]["loss"])
    assert "final loss" in capsys.readouterr().out


def _p2p_entry_points():
    """(name, call(**device kw)) of the p2p and resilience entry points at
    a small size."""
    import numpy as np
    from repro_torch.core.p2p import complete_graph, p2p_dgd_run
    from repro_torch.core.resilience import (estimate_alpha_f,
                                             estimate_delta_c)
    x0 = np.full((4, 3), 2.0, np.float32)
    grad = lambda i, x: x - float(i)
    return {
        "p2p_dgd_run": lambda **kw: p2p_dgd_run(
            complete_graph(4), grad, x0, 2, f=1, combine=make_spec(
                "trimmed_mean", f=1, n=4), **kw),
        "estimate_alpha_f": lambda **kw: estimate_alpha_f(
            "krum", n=5, f=1, trials=2, **kw),
        "estimate_delta_c": lambda **kw: estimate_delta_c(
            "coordinate_median", n=5, f=1, trials=2, **kw)}


@pytest.mark.parametrize("name", ["p2p_dgd_run", "estimate_alpha_f",
                                  "estimate_delta_c"])
def test_p2p_and_resilience_raise_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _p2p_entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    with pytest.raises(RuntimeError, match="CUDA"):
        call(device="cuda")


@pytest.mark.parametrize("name", ["p2p_dgd_run", "estimate_alpha_f",
                                  "estimate_delta_c"])
def test_p2p_and_resilience_run_on_cpu_when_asked(name):
    out = _p2p_entry_points()[name](device="cpu")
    if name == "p2p_dgd_run":
        assert out.shape == (3, 4, 3) and out.device.type == "cpu"
        assert bool(torch.isfinite(out).all())
    elif name == "estimate_alpha_f":
        assert math.isfinite(out[0]) and isinstance(out[1], bool)
    else:
        assert math.isfinite(out) and out >= 0.0
