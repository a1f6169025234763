"""LM serving in the port against the JAX reference (``repro.models``).

For ``qwen3-4b-smoke`` (dense, ``attn_mlp``) and ``falcon-mamba-7b-smoke``
(``ssm``, ``mamba``): the reference's weights, made with ``jax.random`` and
moved through ``repro_torch.bridge.lm_params_from_jax``, and one numpy token
array go through the reference (each function once, under ``jax.jit``, as
it serves) and through the port on the CPU (the kernels' plain versions).
Norm weights, biases, ``D`` and ``A_log`` get seeded noise first, so that
every leaf moves the result.  Compared: the full-sequence ``forward``
logits, the prefill's last-position logits and its caches, and 4
teacher-forced decode steps (logits and the caches after them).  Both sides
compute in f32 (the smoke configs' compute dtype); the tolerance is 1e-5
absolute on O(1) logits and caches: f32 products over widths of 128-384
summed in another order, through 2 layers.  Greedy tokens are compared
where the reference's top-2 margin exceeds 10x that tolerance (argmax can
flip on a near-tie).  The serving compute dtype, bf16, is compared once
more on both sides at a bf16 tolerance (``test_bf16_serving_matches_reference``).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as ref_tf
from repro.models.registry import get_bundle as ref_get_bundle
from repro.models.registry import get_config as ref_get_config
from repro_torch import bridge
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.models.config import GroupCfg, LayerCfg
from repro_torch.utils.pytree import tree_items

torch.set_num_threads(1)

ARCHS = ("qwen3-4b-smoke", "falcon-mamba-7b-smoke")
B, S, N_DECODE = 2, 21, 4
MAX_LEN = S + N_DECODE + 1
ATOL = 1e-5
BF16_STEPS = 4
NOISY = ("ln", "ln1", "ln2", "q_norm", "k_norm", "conv_b", "D", "A_log", "dt_bias")


def _noisy(np_params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (x + 0.1 * rng.normal(size=x.shape)).astype(x.dtype)
        if (path[-1].key in NOISY or path[-2].key == "final_norm") else x,
        np_params,
    )


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """Reference results and the port's bundle and weights for one arch."""
    arch = request.param
    rcfg = ref_get_config(arch)
    np_params = _noisy(jax.tree.map(np.asarray, ref_get_bundle(arch).init(jax.random.key(0))), seed=1)
    rparams = jax.tree.map(jnp.asarray, np_params)
    tokens = np.random.default_rng(2).integers(1, rcfg.vocab, size=(B, S + N_DECODE)).astype(np.int32)
    bundle = registry.get_bundle(arch)
    return {"arch": arch, "bundle": bundle, "np_params": np_params, "tokens": tokens,
            "ref": _reference(rcfg, rparams, tokens), "params": bridge.lm_params_from_jax(np_params, device="cpu")}


def _reference(rcfg, rparams, tokens):
    """The reference's forward, prefill and N_DECODE teacher-forced decode
    steps, each function jitted once, as numpy arrays of the reference's dtypes."""
    fwd = jax.jit(lambda p, t: ref_tf.forward(p, t, rcfg)[0])(rparams, tokens[:, :S])
    logits, pcaches, pos = jax.jit(partial(ref_tf.prefill, cfg=rcfg, max_len=MAX_LEN))(rparams, tokens[:, :S])
    assert int(pos) == S
    decode = jax.jit(partial(ref_tf.decode_step, cfg=rcfg))
    caches, steps = pcaches, []
    for i in range(N_DECODE):
        step_logits, caches = decode(rparams, tokens[:, S + i : S + i + 1], caches, jnp.int32(S + i))
        steps.append(np.asarray(step_logits))
    return {
        "forward": np.asarray(fwd),
        "prefill_logits": np.asarray(logits),
        "prefill_caches": jax.tree.map(np.asarray, pcaches),
        "decode_logits": steps,
        "decode_caches": jax.tree.map(np.asarray, caches),
    }


def _close_caches(got, want, label):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), (label, i)
        for key in w:
            assert tuple(g[key].shape) == w[key].shape, (label, i, key)
            np.testing.assert_allclose(g[key].numpy(), w[key], rtol=0, atol=ATOL, err_msg=f"{label} layer {i} {key}")


def test_forward_logits_match_reference(lm):
    got = lm["bundle"].forward(lm["params"], {"tokens": torch.from_numpy(lm["tokens"][:, :S]).long()})
    assert got.shape == (B, S, lm["bundle"].cfg.vocab)
    np.testing.assert_allclose(got.numpy(), lm["ref"]["forward"], rtol=0, atol=ATOL)


def test_prefill_logits_and_caches_match_reference(lm):
    logits, caches, pos = lm["bundle"].prefill(lm["params"], {"tokens": torch.from_numpy(lm["tokens"][:, :S]).long()},
                                               MAX_LEN)
    assert pos == S and logits.shape == (B, 1, lm["bundle"].cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), lm["ref"]["prefill_logits"], rtol=0, atol=ATOL)
    _close_caches(caches, lm["ref"]["prefill_caches"], "prefill")
    # the prefill's last logits are the forward's at the last position
    np.testing.assert_allclose(logits.numpy()[:, 0], lm["ref"]["forward"][:, -1], rtol=0, atol=ATOL)


def test_teacher_forced_decode_matches_reference(lm):
    """4 decode steps fed the same tokens on both sides."""
    tokens = torch.from_numpy(lm["tokens"]).long()
    bundle = lm["bundle"]
    _, caches, pos = bundle.prefill(lm["params"], {"tokens": tokens[:, :S]}, MAX_LEN)
    for i, want in enumerate(lm["ref"]["decode_logits"]):
        logits, caches = bundle.decode_step(lm["params"], tokens[:, S + i : S + i + 1], caches, pos)
        pos += 1
        np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=ATOL, err_msg=f"decode step {i}")
    _close_caches(caches, lm["ref"]["decode_caches"], "decode")


def test_greedy_tokens_match_where_the_margin_allows(lm):
    """The port's greedy choice at the prefill and at each decode step
    equals the reference's wherever the reference's top-2 margin exceeds
    10x the logit tolerance (a margin below it may flip on last bits)."""
    tokens = torch.from_numpy(lm["tokens"]).long()
    bundle = lm["bundle"]
    logits, caches, pos = bundle.prefill(lm["params"], {"tokens": tokens[:, :S]}, MAX_LEN)
    got = [logits[:, -1].argmax(-1).numpy()]
    for i in range(N_DECODE):
        logits, caches = bundle.decode_step(lm["params"], tokens[:, S + i : S + i + 1], caches, pos)
        pos += 1
        got.append(logits[:, -1].argmax(-1).numpy())
    ref = [lm["ref"]["prefill_logits"][:, -1]] + [x[:, -1] for x in lm["ref"]["decode_logits"]]
    compared = 0
    for g, r in zip(got, ref):
        top2 = np.sort(r, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 10 * ATOL
        np.testing.assert_array_equal(g[clear], r.argmax(-1)[clear])
        compared += int(clear.sum())
    assert compared >= B * (N_DECODE + 1) // 2


def _bf16_step(x):
    """The spacing of bfloat16 numbers (8 significant bits) at x's largest magnitude."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def test_bf16_serving_matches_reference(lm):
    """The serving compute dtype: both sides in bfloat16 from the same f32
    weights (the full configs' path, with its casts after the norms and
    rope, bf16 projections, kernels and caches).  Every output and cache
    leaf has the reference's dtype, so a step left in f32 that the
    reference rounds to bf16 fails here; the values agree within
    BF16_STEPS bf16 steps at each array's largest magnitude.  That is as
    tight as bf16 allows: two correct bf16 implementations round a few
    intermediates differently (XLA's CPU sigmoid differs from torch's in
    the last bf16 bit for about a third of its inputs), and the differences
    grow through the layers to 2.4 steps on the logits and 3.2 on the last
    layer's SSM state here (the first layer's caches agree exactly).  The
    f32 result lies about as far from the bf16 one, so the dtype checks,
    not the values, are what catch a step left in f32."""
    arch = lm["arch"]
    rcfg = ref_get_config(arch, compute_dtype="bfloat16")
    ref = _reference(rcfg, jax.tree.map(jnp.asarray, lm["np_params"]), lm["tokens"])
    bundle = registry.build_bundle(dataclasses.replace(registry.get_config(arch), compute_dtype="bfloat16"))
    tokens = torch.from_numpy(lm["tokens"]).long()

    def close(got, want, label):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (label, got.dtype, want.dtype)
        assert tuple(got.shape) == want.shape, label
        want = want.astype(np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=BF16_STEPS * _bf16_step(want),
                                   err_msg=label)

    def close_caches(got, want, label):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert sorted(g) == sorted(w), (label, i)
            for key in w:
                close(g[key], w[key], f"{label} layer {i} {key}")

    close(bundle.forward(lm["params"], {"tokens": tokens[:, :S]}), ref["forward"], "forward")
    logits, caches, pos = bundle.prefill(lm["params"], {"tokens": tokens[:, :S]}, MAX_LEN)
    close(logits, ref["prefill_logits"], "prefill")
    close_caches(caches, ref["prefill_caches"], "prefill")
    for i, want in enumerate(ref["decode_logits"]):
        logits, caches = bundle.decode_step(lm["params"], tokens[:, S + i : S + i + 1], caches, pos)
        pos += 1
        close(logits, want, f"decode step {i}")
    close_caches(caches, ref["decode_caches"], "decode")


def test_bridge_round_trip_and_port_init_layout(lm):
    """Reference tree -> port -> numpy is the identity, names and layouts
    kept; the port's own init draws the same tree (paths, shapes, dtypes)
    with ``param_count`` elements, from the reference's distributions (each
    leaf's mean and standard deviation within 0.02 + 10% of the reference
    init's, before the test's noise)."""
    back = bridge.lm_params_to_jax(lm["params"])
    want = list(tree_items(lm["np_params"]))
    got = list(tree_items(back))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    init = lm["bundle"].init(torch.Generator().manual_seed(0))
    shapes = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch.")) for p, x in tree_items(init)]
    assert shapes == [(p, x.shape, str(x.dtype)) for p, x in want]
    assert sum(x.numel() for _, x in tree_items(init)) == lm["bundle"].cfg.param_count()
    clean = dict(tree_items(jax.tree.map(np.asarray, ref_get_bundle(lm["arch"]).init(jax.random.key(0)))))
    for path, x in tree_items(init):
        x, r = x.double().numpy(), clean[path].astype(np.float64)
        for stat in (np.mean, np.std):
            assert abs(stat(x) - stat(r)) <= 0.02 + 0.1 * abs(stat(r)), (path, stat.__name__)


def test_serve_cli_runs_on_cpu_and_refuses_cuda_without_gpu(lm):
    arch = lm["arch"]
    r = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "9", "--max-new", "3"])
    assert r["tokens"].shape == (2, 3) and r["logits_finite"]
    assert (r["tokens"] >= 0).all() and (r["tokens"] < lm["bundle"].cfg.vocab).all()
    no_launch = {"flash_attention": 0, "selective_scan": 0}
    assert r["launches"] == {"prefill": no_launch, "decode": no_launch}  # CPU: plain versions
    sampled = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "9", "--max-new", "3",
                          "--temperature", "0.7", "--seed", "3"])
    assert sampled["tokens"].shape == (2, 3) and sampled["logits_finite"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--arch", arch, "--prompt-len", "4", "--max-new", "2"])


def test_registry_configs_and_unported_layers():
    assert {"qwen3-4b", "qwen3-4b-smoke", "falcon-mamba-7b", "falcon-mamba-7b-smoke"} <= set(registry.list_archs())
    for arch in ("qwen3-4b", "falcon-mamba-7b", *ARCHS):
        cfg, rcfg = registry.get_config(arch), ref_get_config(arch)
        assert cfg.param_count() == rcfg.param_count(), arch
        assert cfg.cdtype == getattr(torch, rcfg.compute_dtype) and cfg.pdtype == torch.float32
    assert registry.get_config("qwen3-4b").param_count() == 4_411_424_256
    assert registry.get_config("falcon-mamba-7b").param_count() == 7_272_665_088
    assert registry.get_config("falcon-mamba-7b").ssm.resolve_dt_rank(4096) == 256
    cfg = registry.get_config("qwen3-4b-smoke")
    for family in ("moe", "hybrid", "vlm", "audio"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            registry.build_bundle(dataclasses.replace(cfg, family=family))
    windowed = dataclasses.replace(cfg, groups=(GroupCfg("main", 2, (LayerCfg("attn_mlp", window=8),)),))
    patterned = dataclasses.replace(cfg, groups=(GroupCfg("main", 2, (LayerCfg("attn_mlp"),) * 2),))
    moe_layers = dataclasses.replace(cfg, groups=(GroupCfg("main", 2, (LayerCfg("moe"),)),))
    for unported in (windowed, patterned, moe_layers):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            registry.build_bundle(unported)
    with pytest.raises(KeyError):
        registry.get_config("no-such-arch")


def test_prefill_refuses_a_cache_shorter_than_the_prompt():
    bundle = registry.get_bundle("qwen3-4b-smoke")
    params = bundle.init(torch.Generator().manual_seed(0))
    tokens = torch.ones(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="max_len=6 < prefill len 8"):
        bundle.prefill(params, {"tokens": tokens}, 6)


def test_decode_after_a_mamba_prompt_shorter_than_the_conv_equals_the_forward():
    """A prompt of 2 tokens (< d_conv - 1 = 3): the conv state keeps the
    zeros that stand before the prompt, so two decode steps give the
    forward's logits of the 4-token sequence.  (The reference keeps only the
    prompt's 2 rows there and its decode step then fails; ROADMAP.md Queue 3.)"""
    bundle = registry.get_bundle("falcon-mamba-7b-smoke")
    params = bundle.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(1, 512, size=(2, 4)))
    want = bundle.forward(params, {"tokens": tokens})
    logits, caches, pos = bundle.prefill(params, {"tokens": tokens[:, :2]}, 5)
    assert caches[0]["conv"].shape == (2, 3, 256) and torch.all(caches[0]["conv"][:, 0] == 0)
    torch.testing.assert_close(logits[:, 0], want[:, 1], rtol=0, atol=ATOL)
    for i in (2, 3):
        logits, caches = bundle.decode_step(params, tokens[:, i : i + 1], caches, pos)
        pos += 1
        torch.testing.assert_close(logits[:, 0], want[:, i], rtol=0, atol=ATOL)
