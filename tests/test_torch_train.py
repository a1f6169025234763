"""Decentralized LM training in the port against the JAX reference.

The reference (``repro.launch.train``, ``repro.models``) runs jitted on the
CPU, the port on the CPU (the kernels' plain versions), from the same
numpy-seeded weights (moved through ``repro_torch.bridge``), tokens and
keys:

* ``FlashAttention``'s gradients (``flash_attention_bwd_ref``) against
  ``jax.grad`` of the reference's jnp attention, f32, B 2, H 4 over Hkv 2,
  hd 32, S 37 and 64: 1e-5 of each gradient's largest magnitude (sums over
  up to 64 keys in another order);
* ``lm_loss`` and its gradient tree at ``qwen3-4b-smoke`` (f32) against
  ``jax.value_and_grad``: the loss to 1e-5 and each leaf to 1e-5 of its
  largest magnitude (f32 products over widths of 128-512 through 2
  layers);
* ``make_train_step`` against the reference's at a tiny width (the
  ``qwen3-8b-smoke`` config with d_model 32, vocab 64, d_ff 64), K = 4 on
  a ring, 2 steps of one round, ``obs`` on: exact DRT on the slab, int8 on
  the slab, the edge path under a 25% sign flip with trust_clip 0.15, the
  tree path under a churn schedule with momentum and an adaptive budget
  of up to 3 rounds.
  The agents start apart (seeded noise on one init: DRT's distances are
  differences of Gram entries, badly conditioned when the spread is tiny
  against the norms).  Losses to 1e-5, parameters to 1e-5 of each leaf's
  largest magnitude, momenta to 1e-4 (gradients, summed into the embedding
  token by token in another order, at parameters that already differ by
  f32 rounding; 1.3e-5 measured); the int8 case allows one quantization
  step (below); telemetry field by field (wire bytes, edges and rounds run
  exactly, the rest to 1e-4 of the field's largest magnitude and no less
  than 1e-4: the mixing weights and the fields made of them are O(1));
* ``make_train_many_steps`` bit for bit against single steps, and the
  deprecated ``exchange_dtype`` bit for bit as the cast codec;
* the CLI on ``--device cpu`` (JSONL records, a checkpoint that the
  reference's ``restore_train_state`` reads back), and its refusal of a
  missing GPU;
* the synthetic tokens bit for bit, the optimizers' in-place update (the
  functional one made from it), and the refusals (permute engine, ``ssm``).

The reference compiles at XLA's lowest backend optimization level (the
tolerances hold at any level).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_train_state as ref_restore_train_state
from repro.core.decentralized import TrainerConfig as RefTrainerConfig
from repro.core.dynamic import make_schedule as ref_make_schedule
from repro.core.topology import make_topology as ref_make_topology
from repro.data.synthetic import SyntheticTokenStream as RefStream
from repro.data.synthetic import TokenStreamConfig as RefStreamConfig
from repro.launch import train as ref_train
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro.models.registry import build_bundle as ref_build_bundle
from repro.models.registry import get_config as ref_get_config
from repro.obs.metrics import ObsConfig as RefObsConfig
from repro.optim import momentum as ref_momentum
from repro_torch import bridge
from repro_torch.comm import prng
from repro_torch.comm.codec import init_comm_state
from repro_torch.core.decentralized import TrainerConfig
from repro_torch.core.dynamic import make_schedule
from repro_torch.core.topology import make_topology
from repro_torch.data.synthetic import SyntheticTokenStream, TokenStreamConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train
from repro_torch.models import layers, registry
from repro_torch.models import transformer as tf
from repro_torch.obs.metrics import ConsensusMetrics, ObsConfig
from repro_torch.optim import optimizers as optim
from repro_torch.utils.pytree import container_map, tree_items, tree_leaves, tree_map

torch.set_num_threads(1)

K, STEPS, ROUNDS, BATCH, SEQ = 4, 2, 1, 2, 16
EXACT_FIELDS = ("wire_send_bytes", "wire_recv_bytes", "compression_ratio", "edges", "effective_rounds")
TEL_RTOL = 1e-4


def _compile(fn, *args):
    """``fn`` jitted at XLA's lowest backend optimization level."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})


def _tiny_configs():
    over = dict(num_agents=K, d_model=32, vocab=64, d_ff=64)
    return ref_get_config("qwen3-8b-smoke", **over), registry.get_config("qwen3-8b-smoke", **over)


def _np_init(cfg, seed=0):
    """Seeded weights as numpy arrays: the port's init on the CPU."""
    return bridge.lm_params_to_jax(registry.build_bundle(cfg).init(torch.Generator().manual_seed(seed)))


def _close_tree(got, want, rel, label):
    for (path, a), (_, b) in zip(tree_items(got), tree_items(want)):
        a, b = a.detach().numpy(), np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=f"{label} {path}")


# -- attention gradients -------------------------------------------------------


@pytest.mark.parametrize("S", [37, 64])
def test_flash_attention_gradients_match_jax_grad(S):
    B, H, Hkv, hd = 2, 4, 2, 32
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(B, S, h, hd)).astype(np.float32) for h in (H, Hkv, Hkv))
    w = rng.normal(size=(B, S, H, hd)).astype(np.float32)

    def ref_loss(q, k, v):
        return jnp.sum(ref_layers.flash_attention(q, k, v, causal=True) * w)

    want = _compile(jax.grad(ref_loss, argnums=(0, 1, 2)), q, k, v)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (layers.flash_attention(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max(), err_msg=f"d{name}")


def test_flash_attention_function_runs_the_backward_wrapper_and_lse():
    """The Function saves the forward's log-sum-exp (the plain version's
    ``m + log l``, equal to ``logsumexp`` of the scaled causal scores) and
    its backward is ``flash_attention_bwd``, whose gradients equal autograd
    through the plain forward."""
    B, H, Hkv, S, hd = 1, 4, 2, 19, 32
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, h, S, hd, generator=g) for h in (H, Hkv, Hkv))
    o, lse = fa.flash_attention_ref(q, k, v, return_lse=True)
    s = (q.reshape(B, Hkv, H // Hkv, S, hd) @ k[:, :, None].transpose(-1, -2)) / math.sqrt(hd)
    s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s, -math.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(B, H, S), rtol=0, atol=1e-5)
    do = torch.randn(B, H, S, hd, generator=g)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad((fa.flash_attention_ref(*leaves) * do).sum(), leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
    assert fa.flash_attention_bwd.launches == 0  # CPU calls launch nothing


# -- the LM loss and its gradient ----------------------------------------------


def test_lm_loss_and_gradient_match_reference():
    arch = "qwen3-4b-smoke"
    rcfg = ref_get_config(arch)
    np_params = _np_init(registry.get_config(arch))
    rng = np.random.default_rng(1)
    np_params = jax.tree_util.tree_map_with_path(  # norm weights start at 0: move them
        lambda p, x: (x + 0.1 * rng.normal(size=x.shape)).astype(x.dtype)
        if p[-1].key in ("ln1", "ln2", "q_norm", "k_norm", "w") and x.ndim <= 2 and x.shape[-1] <= 128 else x,
        np_params)
    tokens = rng.integers(0, rcfg.vocab, size=(2, 24)).astype(np.int32)

    def ref_fn(p, t):
        return jax.value_and_grad(ref_tf.lm_loss)(p, {"tokens": t}, None, rcfg)

    want_loss, want_grads = _compile(ref_fn, np_params, tokens)(np_params, tokens)
    params = tree_map(lambda x: x.requires_grad_(True), bridge.lm_params_from_jax(np_params, device="cpu"))
    loss = registry.get_bundle(arch).loss(params, {"tokens": torch.from_numpy(tokens)}, None)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    _close_tree(dict(zip(range(len(grads)), grads)), dict(zip(range(len(grads)), jax.tree.leaves(want_grads))),
                1e-5, "grad")


def test_remat_gives_the_same_gradient():
    """``cfg.remat`` recomputes each layer in the backward pass: the same
    loss and gradients bit for bit, on the plain attention here."""
    cfg = registry.get_config("qwen3-4b-smoke")
    params = registry.build_bundle(cfg).init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 17)))
    out = []
    for remat in (False, True):
        p = tree_map(lambda x: x.clone().requires_grad_(True), params)
        loss = tf.lm_loss(p, {"tokens": tokens}, None, dataclasses.replace(cfg, remat=remat))
        out.append([loss.detach(), *torch.autograd.grad(loss, tree_leaves(p))])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_softmax_cross_entropy_with_a_mask():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, size=(2, 5)).astype(np.int32)
    mask = (rng.random(size=(2, 5)) > 0.4).astype(np.float32)
    for m in (None, mask):
        want = float(_compile(ref_layers.softmax_cross_entropy, logits, labels, m)(logits, labels, m))
        got = float(layers.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                                 None if m is None else torch.from_numpy(m)))
        assert abs(got - want) <= 1e-6


# -- the train step ------------------------------------------------------------


def _case(name):
    """(port TrainerConfig kwargs, reference kwargs, codec)."""
    if name == "exact-slab":
        return {}, {}, None
    if name == "int8-slab":
        return {"codec": "int8"}, {"codec": "int8"}, "int8"
    if name == "edge-signflip-clip":
        kw = dict(consensus_path="edge", byzantine=0.25, fault_model="sign_flip", trust_clip=0.15)
        return kw, dict(kw), None
    # the tree path, churn on the ring, momentum 0.4 and an adaptive budget of
    # 3 whose tol lies between the disagreements after rounds 0 and 1 of step 1
    kw = dict(consensus_path="tree", consensus_momentum=0.4, rounds_policy=f"adaptive:{TREE_TOL}:3")
    return (dict(kw, schedule=make_schedule("ring", K, agent_drop=0.25, seed=1)),
            dict(kw, schedule=ref_make_schedule("ring", K, agent_drop=0.25, seed=1)), None)


TREE_TOL = 5.5


@pytest.fixture(scope="module")
def tiny():
    rcfg, cfg = _tiny_configs()
    np_params = _np_init(cfg)
    # the agents start apart (seeded noise on one init): DRT's distances are
    # differences of Gram entries, well conditioned only when the agents'
    # spread is not tiny against their norms
    rng = np.random.default_rng(7)
    stacked = jax.tree.map(lambda x: (x[None] + 0.05 * rng.normal(size=(K, *x.shape))).astype(np.float32), np_params)
    stream = SyntheticTokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=SEQ))
    tokens = np.stack([stream.agent_batches(BATCH, K, step=i) for i in range(STEPS)])  # (n, K, B, S + 1)
    return {"rcfg": rcfg, "cfg": cfg, "stacked": stacked, "tokens": tokens}


def _reference_run(tiny, rkw, codec):
    rcfg = tiny["rcfg"]
    bundle = ref_build_bundle(rcfg)
    opt = ref_momentum(0.1, 0.9)
    many = ref_train.make_train_many_steps(
        bundle, ref_make_topology("ring", K), opt, RefTrainerConfig(**rkw), consensus_rounds=ROUNDS,
        donate=False, obs=RefObsConfig())
    params = jax.tree.map(jnp.asarray, tiny["stacked"])
    state = ref_train.TrainState(params, opt.init(params), jnp.zeros((), jnp.int32),
                                 ref_train.init_comm_state(codec, params) if codec else ())
    keys = jnp.stack([jax.random.key(i) for i in range(STEPS)])
    batches = {"tokens": jnp.asarray(tiny["tokens"])}
    state, out = _compile(many, state, batches, keys)(state, batches, keys)
    return jax.tree.map(np.asarray, (state.params, state.opt_state, out))


def _port_state(tiny, opt, codec):
    params = bridge.lm_params_from_jax(tiny["stacked"], device="cpu")
    return train.TrainState(params, opt.init(params), 0, init_comm_state(codec, params))


@pytest.mark.parametrize("name", ["exact-slab", "int8-slab", "edge-signflip-clip", "tree-churn-momentum-adaptive"])
def test_train_step_matches_reference(tiny, name):
    kw, rkw, codec = _case(name)
    ref_params, ref_opt, ref_out = _reference_run(tiny, rkw, codec)
    opt = optim.momentum(0.1, 0.9)
    step = train.make_train_step(registry.build_bundle(tiny["cfg"]), make_topology("ring", K), opt,
                                 TrainerConfig(**kw), consensus_rounds=ROUNDS, obs=ObsConfig(), device="cpu")
    state = _port_state(tiny, opt, codec)
    for i in range(STEPS):
        state, metrics = step(state, {"tokens": torch.from_numpy(tiny["tokens"][i])}, prng.key(i))
        assert abs(float(metrics["loss"]) - float(ref_out["loss"][i])) <= 1e-5, (name, i)
        want = ConsensusMetrics(*(np.asarray(x)[i] for x in ref_out["consensus"]))
        for field in ConsensusMetrics._fields:
            a, b = getattr(metrics["consensus"], field).numpy(), getattr(want, field)
            assert a.shape == b.shape, (name, i, field)
            if field in EXACT_FIELDS:
                np.testing.assert_array_equal(a, b, err_msg=f"{name} step {i} {field}")
            else:
                scale = max(float(np.abs(b).max()), 1.0)
                np.testing.assert_allclose(a, b, rtol=0, atol=TEL_RTOL * scale, err_msg=f"{name} step {i} {field}")
        if name.startswith("tree"):
            # the gate compares each round's disagreement with tol: none lies
            # within a factor 1.5 of it, so no last-bit difference flips a round
            dis = want.disagreement
            assert np.all((dis > 1.5 * TREE_TOL) | (dis < TREE_TOL / 1.5)), dis
    if name.startswith("tree"):
        # step 0 runs all 3 rounds, step 1 stops after 2: the gate acted
        assert [int(x) for x in np.asarray(ref_out["consensus"].effective_rounds)[:, -1]] == [3, 2]
    if codec == "int8":
        # the wire's stochastic rounding compares the iterate with a uniform:
        # a last-bit difference of the local step may move a wire entry one
        # quantization step (absmax / 127 of its leaf), and the layer's DRT
        # weights with it.  Parameters are held to one such step; the
        # momenta, gradients at parameters that moved so, to 1e-2 of each
        # leaf's largest magnitude (3e-3 measured)
        for (path, a), (_, b) in zip(tree_items(state.params), tree_items(ref_params)):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= np.abs(np.asarray(b)).max() / 127, path
        _close_tree(state.opt_state["m"], ref_opt["m"], 1e-2, f"{name} momentum")
    else:
        _close_tree(state.params, ref_params, 1e-5, f"{name} params")
        _close_tree(state.opt_state["m"], ref_opt["m"], 1e-4, f"{name} momentum")
    assert state.step == STEPS


def test_many_steps_equal_single_steps_bit_for_bit(tiny):
    bundle = registry.build_bundle(tiny["cfg"])
    opt = optim.momentum(0.1, 0.9)
    tcfg = TrainerConfig(codec="topk:0.25")
    step = train.make_train_step(bundle, make_topology("ring", K), opt, tcfg, device="cpu")
    many = train.make_train_many_steps(bundle, make_topology("ring", K), opt, tcfg, obs=ObsConfig(),
                                       device="cpu")
    single = _port_state(tiny, opt, "topk:0.25")
    losses = []
    for i in range(STEPS):
        single, m = step(single, {"tokens": torch.from_numpy(tiny["tokens"][i])}, prng.key(i))
        losses.append(m["loss"])
    chunk, out = many(_port_state(tiny, opt, "topk:0.25"), {"tokens": torch.from_numpy(tiny["tokens"])},
                      np.stack([prng.key(i) for i in range(STEPS)]))
    assert torch.equal(out["loss"], torch.stack(losses))
    assert out["consensus"].disagreement.shape == (STEPS, 1)
    for part in ("params", "opt_state", "comm"):
        for a, b in zip(tree_leaves(getattr(single, part)), tree_leaves(getattr(chunk, part))):
            assert torch.equal(a, b), part
    assert chunk.step == single.step == STEPS


def test_exchange_dtype_is_the_deprecated_cast_codec(tiny):
    """``exchange_dtype=torch.bfloat16`` warns and trains bit for bit as
    ``codec="bf16"`` (the cast reads no key, so the two key flows agree)."""
    bundle, ring4 = registry.build_bundle(tiny["cfg"]), make_topology("ring", K)
    opt = optim.momentum(0.1, 0.9)
    with pytest.warns(DeprecationWarning, match="exchange_dtype"):
        old = train.make_train_step(bundle, ring4, opt, exchange_dtype=torch.bfloat16, device="cpu")
    new = train.make_train_step(bundle, ring4, opt, codec="bf16", device="cpu")
    a, b = _port_state(tiny, opt, None), _port_state(tiny, opt, None)
    for i in range(STEPS):
        batch = {"tokens": torch.from_numpy(tiny["tokens"][i])}
        a, b = old(a, batch, prng.key(i))[0], new(b, batch, prng.key(i))[0]
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


# -- the CLI -------------------------------------------------------------------


def test_cli_on_cpu_writes_metrics_and_a_checkpoint_the_reference_reads(tmp_path):
    jsonl, ckpt = tmp_path / "m.jsonl", tmp_path / "ck"
    r = train.main(["--device", "cpu", "--steps", "3", "--steps-per-call", "2", "--seq", "16", "--batch", "2",
                    "--metrics-jsonl", str(jsonl), "--ckpt-dir", str(ckpt)])
    assert len(r["losses"]) == 3 and all(math.isfinite(x) for x in r["losses"])
    recs = [__import__("json").loads(line) for line in jsonl.read_text().splitlines()]
    assert [(x["step"], x["round"]) for x in recs] == [(0, 0), (1, 0), (2, 0)]
    tree, step = ref_restore_train_state(str(ckpt))
    assert step == 3
    for (path, a), (_, b) in zip(tree_items(r["state"].params), tree_items(tree["params"])):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=str(path))
    for (_, a), (_, b) in zip(tree_items(r["state"].opt_state), tree_items(tree["opt_state"])):
        np.testing.assert_array_equal(a.numpy(), b)


def test_cli_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CLI would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--steps", "1"])


# -- data, optimizers, bridge, refusals ----------------------------------------


def test_synthetic_tokens_equal_the_reference_bit_for_bit():
    for cfg in (dict(vocab=512, seq_len=33), dict(vocab=40, seq_len=7, seed=3, n_tables=2)):
        ours, ref = SyntheticTokenStream(TokenStreamConfig(**cfg)), RefStream(RefStreamConfig(**cfg))
        for step in (0, 5):
            np.testing.assert_array_equal(ours.agent_batches(3, 5, step=step), ref.agent_batches(3, 5, step=step))


@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov", "adamw", "clip-chain"])
def test_in_place_update_writes_params_and_state_and_leaves_grads(name):
    """``update_`` writes the step into ``params`` and ``opt_state`` (the
    same tensors, the numbers ``update`` returns from copies, which the
    reference parity tests hold) and never writes ``grads``; ``update``
    leaves every input as it was."""
    opt = {
        "sgd": lambda: optim.sgd(0.1),
        "momentum": lambda: optim.momentum(0.1, 0.9),
        "nesterov": lambda: optim.momentum(0.05, 0.8, nesterov=True),
        "adamw": lambda: optim.adamw(1e-3, weight_decay=0.01),
        "clip-chain": lambda: optim.chain(optim.clip_by_global_norm(optim.momentum(0.1), 0.5), optim.sgd(0.01)),
    }[name]()
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(3, 5, generator=g), "b": {"c": torch.randn(3, 2, 2, generator=g)}}
    state = opt.init(params)
    for step in range(3):
        grads = tree_map(lambda x: torch.randn(x.shape, generator=g), params)
        before = [x.clone() for x in _flat((params, state, grads))]
        want_p, want_s = opt.update(grads, state, params, step)
        after = _flat((params, state, grads))
        assert len(after) == len(before) > 2 and all(torch.equal(a, b) for a, b in zip(before, after))
        ids = [id(x) for x in tree_leaves(params)]
        grads_before = tree_map(torch.clone, grads)
        opt.update_(grads, state, params, step)
        assert [id(x) for x in tree_leaves(params)] == ids
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(grads_before)))
        assert all(torch.equal(a, b) for a, b in zip(_flat((params, state)), _flat((want_p, want_s))))


def _flat(tree):
    """Every tensor of nested dicts, tuples and lists, in order."""
    out = []
    container_map(out.append, tree)
    return out


def test_bridge_carries_a_train_state_both_ways():
    rng = np.random.default_rng(0)
    tree = {"params": {"w": rng.normal(size=(K, 2, 3)).astype(np.float32)},
            "opt": ({"m": {"w": rng.normal(size=(K, 2, 3)).astype(np.float32)}}, ()), "comm": ()}
    port = bridge.lm_params_from_jax(tree, device="cpu")
    assert port["comm"] == () and port["opt"][1] == ()
    back = bridge.lm_params_to_jax(port)
    np.testing.assert_array_equal(back["opt"][0]["m"]["w"], tree["opt"][0]["m"]["w"])
    np.testing.assert_array_equal(back["params"]["w"], tree["params"]["w"])


def test_refusals_name_their_roadmap_items(tiny):
    bundle = registry.build_bundle(tiny["cfg"])
    opt = optim.momentum(0.1, 0.9)
    with pytest.raises(NotImplementedError, match="#9"):
        train.make_train_step(bundle, make_topology("ring", K), opt, consensus_impl="permute", device="cpu")
    ssm = registry.get_bundle("falcon-mamba-7b-smoke")
    with pytest.raises(NotImplementedError, match="#5b"):
        train.make_train_step(ssm, make_topology("ring", 4), opt, device="cpu")
    with pytest.raises(ValueError, match="topology"):
        train.make_train_step(bundle, make_topology("ring", K + 1), opt, device="cpu")
    with pytest.raises(ValueError, match="codec"):
        train.make_train_step(bundle, make_topology("ring", K), opt, codec="int8", exchange_dtype=torch.bfloat16,
                              device="cpu")
