"""ResNet-20 for CIFAR-scale images, the paper's own experimental model.

Counterpart of ``repro.models.resnet`` with the same architecture and the
same parameter tree, in torch's layouts: conv weights are OIHW (the
reference's are HWIO), activations NCHW.  Images enter in the data's NHWC
layout, as in the reference, and are permuted on the way in.

* GroupNorm (``min(8, C)`` groups, biased variance, eps 1e-5) instead of
  BatchNorm, so the model carries no running state.
* Stage-uniform block shapes: the stage input is zero-padded to the stage
  width before block 0, so all blocks of a stage stack into one group and
  each residual block is one DRT layer.  ``proj`` is block 0's strided
  shortcut, applied to the padded input; later blocks carry an all-zero,
  unused ``proj`` that is still a parameter.
* Convolutions pad like XLA's ``"SAME"``: a 3x3 stride-2 conv on an even
  input pads (0, 1), not (1, 1).

Agent batching: ``resnet20_forward_agents`` runs K agents' models at once
as ONE grouped network (``groups=K`` convolutions, ``K * groups`` GroupNorm
groups, a batched head), with the agents' channels side by side.  The
agents stay independent, so the gradient of the summed per-agent losses
is every agent's own gradient.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.utils.pytree import tree_map

GN_GROUPS = 8
GN_EPS = 1e-5
STAGES = ("stage1_blocks", "stage2_blocks", "stage3_blocks")


def _conv_init(shape, generator, device):  # OIHW
    fan_in = shape[-3] * shape[-2] * shape[-1]
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (w * math.sqrt(2.0 / fan_in)).to(device)


def _block_params(c, use_proj, generator, device):
    zeros = torch.zeros(c, device=device)
    return {
        "conv1": _conv_init((c, c, 3, 3), generator, device),
        "conv2": _conv_init((c, c, 3, 3), generator, device),
        "gn1_b": zeros.clone(),
        "gn1_w": torch.ones(c, device=device),
        "gn2_b": zeros.clone(),
        "gn2_w": torch.ones(c, device=device),
        "proj": (
            _conv_init((c, c, 1, 1), generator, device)
            if use_proj
            else torch.zeros(c, c, 1, 1, device=device)
        ),
    }


def init_resnet20(
    generator: torch.Generator,
    width: int = 16,
    num_classes: int = 10,
    device: "torch.device | str" = "cpu",
):
    """3 stages x 3 residual blocks, widths (w, 2w, 4w); one agent's tree.
    Draws from ``generator`` (a CPU ``torch.Generator``) and places the
    leaves on ``device``."""
    w1, w2, w3 = width, 2 * width, 4 * width

    def stage(c, first_has_proj):
        blocks = [
            _block_params(c, i == 0 and first_has_proj, generator, device)
            for i in range(3)
        ]
        return tree_map(lambda *xs: torch.stack(xs), *blocks)

    head_w = torch.randn(w3, num_classes, generator=generator) * 0.01
    return {
        "head": {"b": torch.zeros(num_classes, device=device), "w": head_w.to(device)},
        "stage1_blocks": stage(w1, False),
        "stage2_blocks": stage(w2, True),
        "stage3_blocks": stage(w3, True),
        "stem": {
            "conv": _conv_init((w1, 3, 3, 3), generator, device),
            "gn_b": torch.zeros(w1, device=device),
            "gn_w": torch.ones(w1, device=device),
        },
    }


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA "SAME" padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, K):
    """Grouped conv of K agents: x (B, K*I, H, W), w (K, O, I, kh, kw)."""
    _, O, I, kh, kw = w.shape
    ph = _same_pads(x.shape[-2], kh, stride)
    pw = _same_pads(x.shape[-1], kw, stride)
    w = w.reshape(K * O, I, kh, kw)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]), groups=K)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride, groups=K)


def _group_norm(x, w, b, K):
    """Per-agent GroupNorm: agent channels are contiguous, so K * g groups
    over K * C channels are each agent's own g groups."""
    C = w.shape[-1]
    g = min(GN_GROUPS, C)
    return F.group_norm(x, K * g, w.reshape(K * C), b.reshape(K * C), eps=GN_EPS)


def _pad_channels(x, K, c_to):
    B, KC, H, W = x.shape
    c = KC // K
    x = F.pad(x.view(B, K, c, H, W), (0, 0, 0, 0, 0, c_to - c))
    return x.reshape(B, K * c_to, H, W)


def _apply_block(p, x, stride, K):
    h = _conv(x, p["conv1"], stride, K)
    h = F.relu(_group_norm(h, p["gn1_w"], p["gn1_b"], K))
    h = _conv(h, p["conv2"], 1, K)
    h = _group_norm(h, p["gn2_w"], p["gn2_b"], K)
    if stride != 1:
        x = _conv(x, p["proj"], stride, K)
    return F.relu(h + x)


def resnet20_forward_agents(params_K, images_K):
    """K agents' models on their own images in one grouped network.

    ``params_K``: agent-stacked tree (leading K); ``images_K``: (K, B, H, W,
    3) NHWC.  Returns logits (K, B, classes)."""
    K, B = images_K.shape[:2]
    x = images_K.permute(1, 0, 4, 2, 3).reshape(B, K * images_K.shape[-1], *images_K.shape[2:4])
    stem = params_K["stem"]
    x = F.relu(_group_norm(_conv(x, stem["conv"], 1, K), stem["gn_w"], stem["gn_b"], K))
    for si, key in enumerate(STAGES):
        stage = params_K[key]
        c_stage = stage["gn1_w"].shape[-1]
        if x.shape[1] < K * c_stage:
            x = _pad_channels(x, K, c_stage)
        for bi in range(stage["gn1_w"].shape[1]):
            p = {name: leaf[:, bi] for name, leaf in stage.items()}
            x = _apply_block(p, x, 2 if (si > 0 and bi == 0) else 1, K)
    feats = x.mean(dim=(2, 3)).view(B, K, -1)
    head = params_K["head"]
    return torch.einsum("bkc,kcn->kbn", feats, head["w"]) + head["b"][:, None, :]


def resnet20_agent_losses(params_K, batch_K):
    """Per-agent mean cross-entropy, (K,): ``batch_K`` holds ``images`` (K,
    B, H, W, 3) and ``labels`` (K, B)."""
    logits = resnet20_forward_agents(params_K, batch_K["images"])
    K, B, n = logits.shape
    ce = F.cross_entropy(
        logits.reshape(K * B, n), batch_K["labels"].reshape(K * B).long(), reduction="none"
    )
    return ce.view(K, B).mean(dim=1)


def _one_agent(params):
    return tree_map(lambda x: x.unsqueeze(0), params)


def resnet20_forward(params, images):
    """One agent: images (B, H, W, 3) -> logits (B, classes)."""
    return resnet20_forward_agents(_one_agent(params), images.unsqueeze(0))[0]


def resnet20_loss(params, batch):
    """One agent's mean cross-entropy on ``{"images", "labels"}``."""
    return resnet20_agent_losses(
        _one_agent(params),
        {"images": batch["images"].unsqueeze(0), "labels": batch["labels"].unsqueeze(0)},
    )[0]


def resnet20_accuracy(params, batch):
    logits = resnet20_forward(params, batch["images"])
    return (logits.argmax(-1) == batch["labels"].long()).float().mean()
