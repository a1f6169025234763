"""The Mamba-1 selective scan: the SSM LM prefill's recurrence.

``selective_scan(dt, A, Bm, Cm, x)`` runs

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = <h_t, C_t>

from h_0 = 0 over dt, x (B, S, di), A (di, ds) (already ``-exp(A_log)``) and
Bm, Cm (B, S, ds), all f32 but x, which may be bf16 (the full config's
compute dtype).  It returns ``(y, h_last)``: y (B, S, di) f32 and the last
state h_last (B, di, ds) f32, which the decode step starts from.

It replaces the Pallas TPU kernel ``repro/kernels/selective_scan.py``
``selective_scan``, whose y it computes; its h_last is what the reference
model's ``selective_scan_chunked`` returns beside y.  On CUDA tensors the
wrapper launches the hand-written Hopper kernel ``csrc/selective_scan.cu``
(nvcc, sm_90a, bound with ctypes; ds <= 16) or raises; on CPU tensors it
runs :func:`selective_scan_ref`, the plain PyTorch version, one step at a
time in the same arithmetic.  There is no fallback from one to the other.

``selective_scan.launches`` counts kernel launches (one per call; CPU calls
do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.counters import bump

MAX_STATE = 16  # largest ds the kernel takes (csrc kMaxState)
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(dt, A, Bm, Cm, x):
    if x.ndim != 3 or dt.shape != x.shape:
        raise ValueError(f"dt {tuple(dt.shape)} and x {tuple(x.shape)} must both be (B, S, di)")
    B, S, di = x.shape
    if A.ndim != 2 or A.shape[0] != di:
        raise ValueError(f"A {tuple(A.shape)} must be (di={di}, ds)")
    ds = A.shape[1]
    if Bm.shape != (B, S, ds) or Cm.shape != (B, S, ds):
        raise ValueError(f"Bm {tuple(Bm.shape)} and Cm {tuple(Cm.shape)} must be ({B}, {S}, {ds})")
    if len({t.device for t in (dt, A, Bm, Cm, x)}) != 1:
        raise ValueError("selective_scan operands lie on different devices")
    if any(t.dtype != torch.float32 for t in (dt, A, Bm, Cm)):
        raise TypeError("dt, A, Bm and Cm must be float32")


def selective_scan_ref(dt, A, Bm, Cm, x):
    """Plain PyTorch version of :func:`selective_scan` (a loop over S)."""
    _check(dt, A, Bm, Cm, x)
    B, S, di = x.shape
    h = torch.zeros(B, di, A.shape[1], dtype=torch.float32, device=x.device)
    y = torch.empty(B, S, di, dtype=torch.float32, device=x.device)
    xf = x.float()
    for t in range(S):
        dt_t = dt[:, t]
        abar = torch.exp(dt_t[..., None] * A)
        h = abar * h + (dt_t * xf[:, t])[..., None] * Bm[:, t, None, :]
        y[:, t] = (h * Cm[:, t, None, :]).sum(-1)
    return y, h


def selective_scan(dt, A, Bm, Cm, x):
    """``(y, h_last)`` of the scan: the kernel on CUDA tensors,
    :func:`selective_scan_ref` on CPU tensors."""
    _check(dt, A, Bm, Cm, x)
    if x.device.type == "cpu":
        return selective_scan_ref(dt, A, Bm, Cm, x)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan runs on CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"the selective_scan kernel takes float32 or bfloat16 x, got {x.dtype}")
    B, S, di = x.shape
    ds = A.shape[1]
    if ds > MAX_STATE:
        raise ValueError(f"the selective_scan kernel takes d_state <= {MAX_STATE}, got {ds}")
    if not all(t.is_contiguous() for t in (dt, A, Bm, Cm, x)):
        raise ValueError("the selective_scan kernel needs contiguous operands")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid (65535)")
    fn = _kernel()
    y = torch.empty(B, S, di, dtype=torch.float32, device=x.device)
    h_last = torch.empty(B, di, ds, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(), _X_DTYPES[x.dtype],
                 y.data_ptr(), h_last.data_ptr(), B, S, di, ds, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    bump(selective_scan)
    return y, h_last


selective_scan.launches = 0


def _kernel():
    from repro_torch.kernels import build

    fn = build.load("selective_scan").selective_scan_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn
