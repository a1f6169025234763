"""Import hygiene and device policy of the PyTorch port (``src/repro_torch``).

The port must run where JAX is absent: it imports ``torch`` and numpy, never
``jax`` and nothing of the JAX package ``repro``.  Entry points default to
CUDA and raise, rather than carry on quietly on the CPU, when no GPU is
visible and the caller did not ask for ``device="cpu"``.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), os.path.join(ROOT, "src"))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _imported_names(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_source_imports_no_jax_and_no_reference_package():
    bad = []
    n_files = 0
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            n_files += 1
            path = os.path.join(dirpath, f)
            for name in _imported_names(path):
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    bad.append(f"{os.path.relpath(path, ROOT)}: import {name}")
    assert n_files >= 15
    assert not bad, bad


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert "repro_torch.kernels.slab_combine" in mods and "repro_torch.experiment" in mods
    assert "repro_torch.kernels.slab_codec" in mods and "repro_torch.comm.prng" in mods
    assert "repro_torch.kernels.slab_segment" in mods and "repro_torch.core.dynamic" in mods
    assert "repro_torch.kernels.drt_dist" in mods and "repro_torch.comm.exchange" in mods
    assert "repro_torch.kernels.flash_attention" in mods and "repro_torch.kernels.selective_scan" in mods
    assert "repro_torch.models.transformer" in mods and "repro_torch.launch.serve" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-GPU refusal cannot be exercised")


def test_resolve_device_refuses_cuda_without_gpu():
    from repro_torch.device import resolve_device

    _no_gpu()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda:0")


def test_entry_points_refuse_cuda_without_gpu():
    import numpy as np

    from repro_torch import bridge, experiment
    from repro_torch.core.decentralized import DecentralizedTrainer
    from repro_torch.launch import serve
    from repro_torch.core.topology import ring
    from repro_torch.models.resnet import init_resnet20, resnet20_agent_losses
    from repro_torch.optim.optimizers import sgd

    _no_gpu()
    with pytest.raises(RuntimeError, match="cuda"):
        DecentralizedTrainer(
            resnet20_agent_losses, lambda g: init_resnet20(g, width=4), sgd(0.1), ring(4)
        )
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.params_from_jax({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="cuda"):
        experiment.main(["--epochs", "1", "--agents", "4", "--width", "4"])
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.lm_params_from_jax({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen3-4b-smoke", "--prompt-len", "4", "--max-new", "2"])


def test_experiment_refuses_unported_codec():
    """``--codec`` takes the ported wire codecs and refuses other names."""
    from repro_torch import experiment

    for spec in ("identity", "bf16", "f16", "int8", "topk", "topk:0.05"):
        assert experiment.parse_args(["--codec", spec]).codec == spec
    for bad in ("gzip", "topk:2"):
        with pytest.raises(SystemExit):
            experiment.parse_args(["--codec", bad])


class _OnCard(torch.Tensor):
    """A meta tensor that reports a CUDA device, so a kernel wrapper takes
    its card path on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta").as_subclass(_OnCard)


def test_kernel_wrappers_raise_on_cuda_tensors_when_the_build_fails(monkeypatch):
    """Given CUDA operands, every kernel wrapper builds its kernel and
    raises when the build fails; none falls back to its plain version."""
    from repro_torch.kernels import (build, drt_dist, flash_attention, selective_scan, slab_codec, slab_combine,
                                     slab_segment)

    def failed_build(name):
        raise RuntimeError(f"kernel build failed:\n{name}: nvcc exited 1")

    def fell_back(*a, **k):
        raise AssertionError("a kernel wrapper fell back to its plain version")

    monkeypatch.setattr(build, "load", failed_build)
    monkeypatch.setattr(slab_codec, "_typed_lib", None)
    monkeypatch.setattr(slab_segment, "_typed_lib", None)
    for mod, names in ((slab_combine, ["slab_combine_ref", "slab_source_combine_ref"]),
                       (drt_dist, ["drt_dist_ref"]),
                       (slab_codec, ["slab_quant_encode_ref", "slab_encode_combine_ref"]),
                       (slab_segment, ["slab_edge_encode_combine_ref", "slab_edge_combine_ref"]),
                       (flash_attention, ["flash_attention_ref"]), (selective_scan, ["selective_scan_ref"])):
        for n in names:
            monkeypatch.setattr(mod, n, fell_back)

    K, nb, L, E = 4, 2, 2, 8
    D = nb * 128
    i32 = torch.int32
    slab, bl = _on_card(K, D), _on_card(nb, dtype=i32)
    int8_ops = (_on_card(K, 3), _on_card(D, dtype=i32), _on_card(D, dtype=i32), _on_card(D, dtype=i32),
                _on_card(K, 5, dtype=i32), _on_card(K, 5, dtype=i32))
    edges = (_on_card(E, dtype=i32), _on_card(E, dtype=i32), _on_card(E))
    csr = tuple(_on_card(K, 2, dtype=i32) for _ in range(3))
    calls = [
        lambda: slab_combine.slab_combine(_on_card(nb, K, K), slab),
        lambda: slab_codec.slab_quant_encode(*int8_ops, slab),
        lambda: slab_codec.slab_encode_combine(bl, slab, (), _on_card(K, K), mode="bf16", num_layers=L),
        lambda: slab_segment.slab_edge_encode_combine(bl, slab, (slab,), *edges, *csr, mode="exact",
                                                      num_layers=L),
        lambda: slab_segment.slab_edge_combine(bl, slab, slab, *edges, algorithm="classical", num_layers=L),
        lambda: slab_combine.slab_source_combine(_on_card(nb, 3), _on_card(3, D)),
        lambda: drt_dist.drt_dist(_on_card(D), _on_card(D)),
        lambda: flash_attention.flash_attention(_on_card(1, 4, 8, 32), _on_card(1, 2, 8, 32), _on_card(1, 2, 8, 32)),
        lambda: selective_scan.selective_scan(_on_card(1, 8, 16), _on_card(16, 4), _on_card(1, 8, 4),
                                              _on_card(1, 8, 4), _on_card(1, 8, 16)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc exited 1"):
            call()
