"""ResNet-20, the weight bridge and the optimizers against the reference.

Weights move from the JAX tree (HWIO) into the port (OIHW) through
``repro_torch.bridge``; images and labels are seeded numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import resnet as ref_resnet
from repro.optim import optimizers as ref_optim
from repro_torch import bridge
from repro_torch.models import resnet
from repro_torch.optim import optimizers
from repro_torch.optim.schedule import constant
from repro_torch.utils.pytree import tree_items, tree_map

torch.set_num_threads(1)


def _ref_params(width=4, seed=0, K=None):
    """Reference-layout weights as numpy (from a port init carried across:
    cheaper than an op-by-op jax.random init, same shapes)."""
    g = torch.Generator().manual_seed(seed)
    if K is None:
        return bridge.params_to_jax(resnet.init_resnet20(g, width=width))
    draws = [bridge.params_to_jax(resnet.init_resnet20(g, width=width)) for _ in range(K)]
    return jax.tree.map(lambda *xs: np.stack(xs), *draws)


def _batch(rng, B, size, K=None):
    lead = (B,) if K is None else (K, B)
    return {
        "images": rng.normal(size=(*lead, size, size, 3)).astype(np.float32),
        "labels": rng.integers(0, 10, size=lead).astype(np.int32),
    }


def _close_trees(got_np, want, rtol, atol):
    got_items = list(tree_items(got_np))
    want_items = list(tree_items(jax.tree.map(np.asarray, want)))
    assert [p for p, _ in got_items] == [p for p, _ in want_items]
    for (path, a), (_, b) in zip(got_items, want_items):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=str(path))


def test_forward_loss_and_grads_match_reference():
    """XLA's "SAME" convs (stride-2 pads (0, 1) on even inputs) and
    GroupNorm reproduced: logits and loss to f32 rounding of a different
    conv summation order (1e-5), per-leaf grads to 1e-4 relative."""
    p_np = _ref_params()
    b = _batch(np.random.default_rng(8), 4, 8)
    p_t = tree_map(lambda x: x.requires_grad_(True), bridge.params_from_jax(p_np, device="cpu"))
    b_t = {k: torch.from_numpy(v) for k, v in b.items()}

    def ref_fn(p, batch):
        return ref_resnet.resnet20_loss(p, batch), ref_resnet.resnet20_forward(p, batch["images"])

    (loss_ref, logits_ref), g_ref = jax.jit(jax.value_and_grad(ref_fn, has_aux=True))(p_np, b)
    logits = resnet.resnet20_forward(p_t, b_t["images"])
    np.testing.assert_allclose(logits.detach().numpy(), logits_ref, rtol=1e-5, atol=1e-5)
    loss = resnet.resnet20_loss(p_t, b_t)
    assert abs(loss.item() - float(loss_ref)) < 1e-5
    _close_trees(_grads(loss, p_t), g_ref, rtol=1e-4, atol=1e-6)


def _grads(loss, params):
    """Per-leaf grads as a reference-layout numpy tree (zeros for leaves the
    loss never reads, as JAX reports them)."""
    leaves = [x for _, x in tree_items(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads))
    return bridge.params_to_jax(tree_map(lambda _: next(it), params))


def test_agent_batched_losses_equal_each_agents_own():
    """The grouped K-agent network is K independent models: its per-agent
    losses match the reference vmapped over agents, and the gradient of
    their sum is each agent's own gradient.  Odd 7x7 images exercise the
    general SAME rule (stride-2 pads (1, 1) there)."""
    K = 3
    p_np = _ref_params(K=K, seed=4)
    b = _batch(np.random.default_rng(5), 4, 7, K=K)
    p_t = tree_map(lambda x: x.requires_grad_(True), bridge.params_from_jax(p_np, device="cpu"))
    losses = resnet.resnet20_agent_losses(p_t, {k: torch.from_numpy(v) for k, v in b.items()})
    l_ref, g_ref = jax.jit(jax.vmap(jax.value_and_grad(ref_resnet.resnet20_loss)))(p_np, b)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(l_ref), rtol=1e-5, atol=1e-5)
    _close_trees(_grads(losses.sum(), p_t), g_ref, rtol=1e-4, atol=1e-6)


def test_bridge_roundtrip_is_exact_and_converts_layouts():
    p_np = _ref_params(K=2)
    moments = {"m": p_np, "v": jax.tree.map(np.square, p_np)}
    t = bridge.params_from_jax(moments, device="cpu")
    # HWIO (K, n, 3, 3, I, O) -> OIHW (K, n, O, I, 3, 3), agent and slot axes kept
    hwio = p_np["stage2_blocks"]["conv1"]
    oihw = t["m"]["stage2_blocks"]["conv1"]
    assert oihw.shape == (2, 3, hwio.shape[-1], hwio.shape[-2], 3, 3)
    np.testing.assert_array_equal(oihw[1, 2, 5, 3].numpy(), hwio[1, 2, :, :, 3, 5])
    back = bridge.params_to_jax(t)
    for (pa, a), (pb, b) in zip(tree_items(back), tree_items(moments)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_optimizer_updates_match_reference(name):
    """Three steps of each optimizer on seeded trees; elementwise f32 math,
    so 1e-6 relative (AdamW's sqrt/divide may round differently)."""
    rng = np.random.default_rng(11)
    params = {"a": {"w": rng.normal(size=(2, 5, 3)).astype(np.float32)},
              "b": rng.normal(size=(2, 4)).astype(np.float32)}
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
             for _ in range(3)]
    make = {
        "sgd": (lambda m: m.sgd(0.1)),
        "momentum": (lambda m: m.momentum(0.05, 0.9)),
        "adamw": (lambda m: m.adamw(1e-2, weight_decay=0.01)),
    }[name]
    ref_opt, opt = make(ref_optim), make(optimizers)
    rp, rs = jax.tree.map(jnp.asarray, params), None
    tp = tree_map(torch.from_numpy, params)
    rs, ts = ref_opt.init(rp), opt.init(tp)
    for step, g in enumerate(grads):
        rp, rs = ref_opt.update(jax.tree.map(jnp.asarray, g), rs, rp, jnp.asarray(step, jnp.int32))
        tp, ts = opt.update(tree_map(torch.from_numpy, g), ts, tp, step)
    _close_trees(tree_map(lambda x: x.numpy(), tp), rp, rtol=1e-6, atol=1e-7)
    if name != "sgd":
        _close_trees(tree_map(lambda x: x.numpy(), ts), rs, rtol=1e-6, atol=1e-7)


def test_constant_schedule():
    sched = constant(0.05)
    opt = optimizers.sgd(sched)
    p = {"w": torch.ones(3)}
    new, _ = opt.update({"w": torch.ones(3)}, opt.init(p), p, 7)
    torch.testing.assert_close(new["w"], torch.full((3,), 0.95))
