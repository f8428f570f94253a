"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``): the same npz layout, so a parameter
tree saved by either package restores in the other (a bf16 leaf crosses
as fp32 and comes back bit for bit); ``latest_step``; the missing-leaf
and shape-mismatch errors; and the loops' ``ckpt_dir`` / ``ckpt_every``
on a 2-step CPU run (with ``telemetry=True`` and no recorder)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.aggregators import make_spec
from repro_torch.data import SyntheticLM
from repro_torch.optim import adamw, constant
from repro_torch.training import ByzantineConfig, train_loop
from repro_torch.tree import tree_items

torch.set_num_threads(2)


def _params_np():
    """A small parameter tree in the JAX layout with a bf16 leaf."""
    rng = np.random.default_rng(0)
    return {"embed": rng.normal(size=(6, 4)).astype(np.float32),
            "layers": {"w": rng.normal(size=(2, 4, 4)).astype(
                           jnp.bfloat16),
                       "b": rng.normal(size=(2, 4)).astype(np.float32)}}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def _assert_same(torch_tree, np_tree):
    for (path, t), n in zip(tree_items(torch_tree),
                            jax.tree.leaves(np_tree)):
        assert str(t.dtype).endswith(str(np.asarray(n).dtype)), path
        ours = (t.view(torch.uint16) if t.dtype == torch.bfloat16
                else t).numpy()
        np.testing.assert_array_equal(ours, _bits(n), err_msg=str(path))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    ref = _params_np()
    jax_save(str(tmp_path), 3, jax.tree.map(jnp.asarray, ref))
    like = params_from_numpy(jax.tree.map(np.zeros_like, ref))
    out, step = restore(str(tmp_path), like)
    assert step == 3
    _assert_same(out, ref)


def test_port_checkpoint_restores_in_jax(tmp_path):
    ref = _params_np()
    save(str(tmp_path), 5, params_from_numpy(ref))
    out, step = jax_restore(str(tmp_path), jax.tree.map(
        lambda x: jnp.zeros(x.shape, x.dtype), ref))
    assert step == 5
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_latest_step_and_restore_errors(tmp_path):
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        restore(d, {"a": torch.zeros(2)})
    tree = {"a": torch.arange(3.0), "opt": {"step": 7}}
    save(d, 1, tree)
    save(d, 12, tree)
    assert latest_step(d) == 12
    out, step = restore(d, {"a": torch.zeros(3), "opt": {"step": 0}}, step=1)
    assert step == 1 and out["opt"]["step"] == 7
    assert torch.equal(out["a"], tree["a"])
    with pytest.raises(KeyError, match="missing leaf b"):
        restore(d, {"a": torch.zeros(3), "b": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch for a"):
        restore(d, {"a": torch.zeros(4)})


def test_loop_writes_its_checkpoints(tmp_path):
    cfg = get_config("paper-100m-smoke").replace(vocab_size=32,
                                                 dtype="float32")
    ds = SyntheticLM(vocab_size=32, seq_len=8, n_agents=4,
                     per_agent_batch=1)
    bz = ByzantineConfig(n_agents=4, f=1,
                         aggregator=make_spec("trimmed_mean", f=1, n=4))
    d = str(tmp_path / "ck")
    params, _ = train_loop(cfg, bz, adamw(constant(1e-3)), ds, steps=2,
                           ckpt_dir=d, ckpt_every=1, telemetry=True,
                           log_fn=lambda *_: None, device="cpu")
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000001.npz", "step_00000002.npz"]
    like = {"params": params, "opt": adamw(constant(1e-3)).init(params)}
    out, step = restore(d, like)
    assert step == 2 and out["opt"]["step"] == 2
    for (_, a), (_, b) in zip(tree_items(out["params"]),
                              tree_items(params)):
        assert torch.equal(a, b.detach())
