"""The port's checkpoints (``repro_torch.ckpt``) against the reference's.

* a train state saved and restored bit for bit under every codec (None,
  identity, bf16, f16, int8, top-k with its residual), and a stateless
  optimizer's empty state as ``()``;
* a run of 2 steps, saved, restored into a fresh trainer and run 2 more
  steps, bit-identical to an uninterrupted run of 4 (as the reference's
  ``tests/test_checkpoint.py``: K=4 ring, DIM 6, momentum);
* a file written by ``repro.ckpt.save_train_state`` restores into the port
  and matches through ``repro_torch.bridge`` (HWIO to OIHW), and the port's
  file restores into the reference;
* the manifest's ``latest``, no temporary file left, and a bf16 leaf
  refused by name.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as ref_ckpt
from repro_torch import bridge
from repro_torch.ckpt import (
    latest_step,
    restore_checkpoint,
    restore_train_state,
    save_checkpoint,
    save_train_state,
)
from repro_torch.core.decentralized import DecentralizedState, DecentralizedTrainer, TrainerConfig
from repro_torch.core.topology import ring
from repro_torch.optim.optimizers import momentum, sgd
from repro_torch.utils.pytree import tree_items, tree_map

ALL_CODECS = [None, "identity", "bf16", "f16", "int8", "topk:0.25"]
K, DIM = 4, 6


def _setup(codec, opt=None):
    """The reference test's quadratic problem: each agent pulls an
    ``embed`` leaf and a 2-slot ``blocks`` leaf toward its own target."""
    targets = torch.from_numpy(np.random.default_rng(5).normal(size=(K, DIM)).astype(np.float32))

    def init_fn(generator):
        return {"embed": {"w": torch.zeros(DIM)}, "blocks": {"w": torch.zeros(2, DIM)}}

    def loss_fn(params, batch):
        return (((params["embed"]["w"] - batch) ** 2).sum(1)
                + ((params["blocks"]["w"] - batch[:, None]) ** 2).sum((1, 2)))

    tr = DecentralizedTrainer(loss_fn, init_fn, opt or momentum(0.05, 0.9), ring(K),
                              TrainerConfig(consensus_steps=2, codec=codec), device="cpu")
    return tr, targets


def _run_steps(tr, st, targets, n):
    for _ in range(n):
        st, _ = tr.local_step(st, targets)
        st, _ = tr.consensus(st)
    return st


def _assert_bitwise(a, b):
    ia, ib = list(tree_items(a)), list(tree_items(b))
    assert [p for p, _ in ia] == [p for p, _ in ib]
    for (p, x), (_, y) in zip(ia, ib):
        x, y = torch.as_tensor(np.asarray(x)), torch.as_tensor(np.asarray(y))
        assert x.dtype == y.dtype and torch.equal(x, y), p


@pytest.mark.parametrize("codec", ALL_CODECS)
def test_train_state_round_trip_bitwise_per_codec(tmp_path, codec):
    tr, targets = _setup(codec)
    st = _run_steps(tr, tr.init(torch.Generator().manual_seed(0)), targets, 3)
    if codec == "topk:0.25":  # a residual worth keeping
        assert sum(float(r.abs().sum()) for _, r in tree_items(st.comm)) > 0
    save_train_state(str(tmp_path), st)
    tree, step = restore_train_state(str(tmp_path), device="cpu")
    assert step == 3 and int(tree["step"]) == 3
    _assert_bitwise(tree["params"], st.params)
    _assert_bitwise(tree["opt_state"], st.opt_state)
    if st.comm == ():
        assert tree["comm"] == ()
    else:
        _assert_bitwise(tree["comm"], st.comm)
    assert all(x.device.type == "cpu" for _, x in tree_items(tree["params"]))


def test_stateless_optimizer_round_trips_as_empty(tmp_path):
    tr, targets = _setup(None, opt=sgd(0.05))
    st = _run_steps(tr, tr.init(torch.Generator().manual_seed(0)), targets, 2)
    assert st.opt_state == () and st.comm == ()
    save_train_state(str(tmp_path), st)
    tree, step = restore_train_state(str(tmp_path), device="cpu")
    assert step == 2 and tree["opt_state"] == () and tree["comm"] == ()
    _assert_bitwise(tree["params"], st.params)


@pytest.mark.parametrize("codec", ["int8", "topk:0.25"])
def test_resumed_run_continues_identically(tmp_path, codec):
    """2 steps, save, restore into a fresh trainer, 2 more steps: the same
    bits as 4 steps without a break (the residual carries over; the coded
    exchange's key is a function of the restored step)."""
    tr, targets = _setup(codec)
    st2 = _run_steps(tr, tr.init(torch.Generator().manual_seed(0)), targets, 2)
    save_train_state(str(tmp_path), st2)
    st4_live = _run_steps(tr, st2, targets, 2)

    tree, step = restore_train_state(str(tmp_path), device="cpu")
    tr2, _ = _setup(codec)
    tr2.build_partition(tree["params"])
    st = DecentralizedState(tree["params"], tree["opt_state"], int(tree["step"]), tree["comm"])
    st4 = _run_steps(tr2, st, targets, 2)
    assert step == 2 and st4.step == st4_live.step == 4
    _assert_bitwise(st4.params, st4_live.params)
    _assert_bitwise(st4.opt_state, st4_live.opt_state)
    _assert_bitwise(st4.comm, st4_live.comm)


class _RefState:
    """What the reference's ``save_train_state`` reads off a state."""

    def __init__(self, params, opt_state, step, comm):
        self.params, self.opt_state, self.step, self.comm = params, opt_state, step, comm


def _reference_layout_state(seed=3):
    """A train state in the reference's layout (HWIO convolutions, an
    agent axis, a stacked group): params, momentum, top-k residual."""
    rng = np.random.default_rng(seed)

    def tree():
        return {"stem": {"conv": rng.normal(size=(K, 3, 3, 2, 4)).astype(np.float32)},
                "stage1_blocks": {"conv1": rng.normal(size=(K, 2, 3, 3, 4, 4)).astype(np.float32),
                                  "gn1": {"scale": rng.normal(size=(K, 2, 4)).astype(np.float32)}},
                "head": {"w": rng.normal(size=(K, 4, 10)).astype(np.float32)}}

    return tree(), {"m": tree()}, 7, tree()


def test_reference_file_restores_into_the_port_through_the_bridge(tmp_path):
    params, opt, step, comm = _reference_layout_state()
    as_jax = lambda t: tree_map(jnp.asarray, t)  # noqa: E731
    ref_ckpt.save_train_state(str(tmp_path), _RefState(as_jax(params), as_jax(opt), jnp.asarray(step, jnp.int32),
                                                       as_jax(comm)))
    tree, got_step = restore_train_state(str(tmp_path), device="cpu")
    assert got_step == step and int(tree["step"]) == step
    _assert_bitwise(tree["params"], params)  # the reference's layout, as written
    port = {k: bridge.params_from_jax(tree_map(lambda x: x.numpy(), tree[k]), device="cpu")
            for k in ("params", "opt_state", "comm")}
    want = {"params": params, "opt_state": opt, "comm": comm}
    for k, v in want.items():
        _assert_bitwise(port[k], bridge.params_from_jax(v, device="cpu"))
    assert tuple(port["params"]["stem"]["conv"].shape) == (K, 4, 2, 3, 3)  # OIHW


def test_port_file_restores_into_the_reference(tmp_path):
    params, opt, step, comm = _reference_layout_state(4)
    to_port = lambda t: bridge.params_from_jax(t, device="cpu")  # noqa: E731
    st = DecentralizedState(to_port(params), to_port(opt), step, to_port(comm))
    save_train_state(str(tmp_path), st)
    tree, got_step = ref_ckpt.restore_train_state(str(tmp_path))
    assert got_step == step and int(tree["step"]) == step
    for k in ("params", "opt_state", "comm"):
        _assert_bitwise(tree[k], getattr(st, k))  # the port's layout, as written
        _assert_bitwise(bridge.params_to_jax(tree_map(torch.from_numpy, tree[k])),
                        {"params": params, "opt_state": opt, "comm": comm}[k])


def test_manifest_lists_and_refusals(tmp_path):
    """``latest`` is the largest step saved, any step restores, no temporary
    file is left; lists and tuples come back as lists; a bf16 leaf raises
    naming it; nothing saved raises ``FileNotFoundError``."""
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, device="cpu")
    tree = {"a": [torch.arange(3), (torch.ones(2), torch.zeros(1, dtype=torch.int8))], "b": torch.tensor(2.5)}
    save_checkpoint(d, 5, tree)
    save_checkpoint(d, 2, {"b": torch.tensor(1.0)})
    assert latest_step(d) == 5
    assert sorted(os.listdir(d)) == ["manifest.json", "step_00000002.npz", "step_00000005.npz"]
    got, step = restore_checkpoint(d, device="cpu")
    assert step == 5 and isinstance(got["a"], list) and isinstance(got["a"][1], list)
    _assert_bitwise(got["a"][1][1], tree["a"][1][1])
    assert float(restore_checkpoint(d, 2, device="cpu")[0]["b"]) == 1.0
    ref_tree, _ = ref_ckpt.restore_checkpoint(d)
    assert ref_tree["a"][0].tolist() == [0, 1, 2] and ref_tree["a"][1][1].dtype == np.int8
    with pytest.raises(TypeError, match="blocks/w"):
        save_checkpoint(d, 6, {"blocks": {"w": torch.ones(3, dtype=torch.bfloat16)}})
    assert latest_step(d) == 5
