"""RWKV6 (Finch) WKV over a whole sequence, with its final state.

:func:`wkv6` runs ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` and
``o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)`` from a zero state for each
(batch, head) and returns ``o`` and the final float32 state. On a CUDA
tensor it launches the hand-written Hopper kernel ``csrc/wkv6.cu``, which
replaces the TPU kernel ``repro/kernels/rwkv6_chunk.py::wkv6_chunked``
(``pallas_call`` at ``rwkv6_chunk.py:106``); on a CPU tensor it takes
:func:`wkv6_plain`, which follows ``ref.wkv6`` (a sequential loop in
float32). There is no fallback from one to the other.

The kernel keeps the recurrence sequential, so it is exact for any decay;
the TPU kernel's chunked form divides by cumulative decays clamped at
1e-30 instead. Its grid splits each state's columns into slices, one block
a (batch, head, slice), and each column's rows over lanes of one warp:
:func:`wkv6_grid` sizes both.

Bound: operations on a dependent chain of tokens (about 6.7 GFLOP a layer
at RWKV6-3B's 4 x 2,048-token prefill, 0.10 ms at 67 TFLOP/s of float32);
the times are in ``PERF.md``.

Gradients: on a CPU tensor autograd differentiates the plain version. On a
CUDA tensor that needs a gradient, :class:`WKV6` launches the forward kernel
and, for the gradient, the hand-written kernel ``csrc/wkv6_bwd.cu``
(:func:`wkv6_bwd`): one thread block cluster a (batch, head), a block a
slice of the state's columns, whose row sums are finished inside the
cluster; :func:`wkv6_bwd_grid` and :func:`wkv6_bwd_cells` mirror its launch
geometry. The JAX package has no backward kernel: ``jax.grad`` through its
Pallas kernel raises and ``repro/kernels/ops.py`` trains through
``ref.wkv6`` (``ref.py:91``), whose gradient this is.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
# blocks the kernel's grid aims at per SM, by splitting the state's columns
BLOCKS_PER_SM = 2
MAX_THREADS = 256  # kMaxThreads of csrc/wkv6.cu
ROW_GROUPS = 8  # lanes of one warp that share a column group (kGroups)
COLUMNS_PER_LANE = 2  # kCols of csrc/wkv6.cu
MIN_COLUMNS = 8  # a slice's v row is at least one 16-byte cp.async piece
# csrc/wkv6_bwd.cu: tokens between checkpoints, state columns a block (hd /
# BWD_SLICE blocks a cluster), columns a thread and rows a thread by head size
# (BWD_SLICE / BWD_COLS consecutive lanes share a group of rows, hd / rows
# apart)
BWD_CHUNK = 8
BWD_SLICE = 16
BWD_COLS = 4
BWD_ROWS = {16: 2, 32: 4, 64: 4, 128: 4}


def wkv6_grid(hd: int, heads: int, sm_count: int) -> tuple[int, int]:
    """``(columns a block, column slices a head)`` of the kernel's launch
    for ``heads`` (batch x heads) state matrices of ``hd`` columns on
    ``sm_count`` SMs. ``ROW_GROUPS`` lanes share each group of
    ``COLUMNS_PER_LANE`` columns, ``hd / ROW_GROUPS`` rows each. The slices
    are the fewest whose blocks fit ``MAX_THREADS`` threads, doubled while
    the grid is short of ``BLOCKS_PER_SM`` blocks an SM and a slice keeps
    ``MIN_COLUMNS`` columns."""
    slices = max(1, hd // COLUMNS_PER_LANE * ROW_GROUPS // MAX_THREADS)
    while heads * slices < BLOCKS_PER_SM * sm_count and hd // (2 * slices) >= MIN_COLUMNS:
        slices *= 2
    return hd // slices, slices


def wkv6_bwd_grid(hd: int, batch: int, heads: int) -> dict:
    """The backward kernel's launch: ``hd / BWD_SLICE`` blocks a cluster,
    one cluster a (batch, head), a block of ``hd / BWD_ROWS[hd] * BWD_SLICE
    / BWD_COLS`` threads; the grid ``(heads * slices, batch)``."""
    slices = hd // BWD_SLICE
    return {"cluster": slices, "threads": hd // BWD_ROWS[hd] * BWD_SLICE // BWD_COLS,
            "grid": (heads * slices, batch)}


def wkv6_bwd_cells(hd: int, block_x: int) -> dict:
    """``{thread: (head, rows, columns)}`` of block ``block_x`` of the
    backward kernel's grid, by its index arithmetic: its head and slice from
    ``block_x``, then ``BWD_SLICE / BWD_COLS`` consecutive lanes a group of
    ``BWD_ROWS[hd]`` state rows (``i``, ``i + stride``, .., ``stride = hd /
    BWD_ROWS[hd]``), ``BWD_COLS`` adjacent columns each."""
    slices = hd // BWD_SLICE
    groups = BWD_SLICE // BWD_COLS
    stride = hd // BWD_ROWS[hd]
    head, j0 = block_x // slices, (block_x % slices) * BWD_SLICE
    cells = {}
    for tid in range(wkv6_bwd_grid(hd, 1, 1)["threads"]):
        i = tid // groups
        c0 = j0 + (tid % groups) * BWD_COLS
        cells[tid] = (head, tuple(range(i, hd, stride)), tuple(range(c0, c0 + BWD_COLS)))
    return cells


def wkv6_plain(r, k, v, w, u):
    """Plain PyTorch version of ``ref.wkv6``: the recurrence token by token
    in float32. Returns ``(o in r's dtype, state (B, H, hd, hd) float32)``."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        at = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], state + uf * at))
        state = wf[:, t, :, :, None] * state + at
    if outs:
        o = torch.stack(outs, dim=1)
    else:
        o = torch.zeros((B, 0, H, hd), dtype=torch.float32, device=r.device)
    return o.to(r.dtype), state


def wkv6_bwd_plain(r, k, v, w, u, do, dstate=None):
    """(dr, dk, dv, dw, du): autograd of :func:`wkv6_plain` at the output
    gradient ``do`` and the final state's ``dstate`` (None: zeros), each in
    its input's dtype (zeros where nothing depends on it: w of the last
    token without ``dstate``)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (r, k, v, w, u)]
        o, state = wkv6_plain(*leaves)
        outs, grads = [o], [do]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate)
        got = torch.autograd.grad(outs, leaves, grads, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(leaves, got))


def _check(r, k, v, w, u) -> None:
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape or w.shape != r.shape:
        raise ValueError(
            f"want r, k, v, w of one shape (B,S,H,hd), got {tuple(r.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(w.shape)}"
        )
    B, S, H, hd = r.shape
    if u.shape != (H, hd):
        raise ValueError(f"u must be (H, hd) = {(H, hd)}, got {tuple(u.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} not in {HEAD_DIMS}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(
            f"r, k and v must share one of {list(_DTYPES)}, got "
            f"{r.dtype}, {k.dtype}, {v.dtype}"
        )
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"w and u must be float32, got {w.dtype}, {u.dtype}")
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u)):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")


def _launch(r, k, v, w, u):
    _check(r, k, v, w, u)
    B, S, H, hd = r.shape
    # the kernel stages r, k, v and w by 16-byte copies
    r, k, v, w, u = (t.contiguous() if t.data_ptr() % 16 == 0
                     else t.clone(memory_format=torch.contiguous_format)
                     for t in (r, k, v, w, u))
    o = torch.empty_like(r)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B == 0 or H == 0:
        return o, state
    cols, _ = wkv6_grid(hd, B * H, _build.sm_count(r.device.index or 0))
    fn = _build.function("wkv6", "wkv6_launch", [
        *[ctypes.c_void_p] * 7, *[ctypes.c_int] * 6, ctypes.c_void_p,
    ])
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), o.data_ptr(), state.data_ptr(), _DTYPES[r.dtype],
                B, S, H, hd, cols, stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc}")
    wkv6.launches += 1
    return o, state


def _launch_bwd(r, k, v, w, u, do, dstate):
    _check(r, k, v, w, u)
    B, S, H, hd = r.shape
    if do.shape != r.shape or do.device != r.device:
        raise ValueError(f"do must be like r {tuple(r.shape)} on {r.device}, got "
                         f"{tuple(do.shape)} on {do.device}")
    if dstate is not None and (dstate.shape != (B, H, hd, hd) or dstate.device != r.device):
        raise ValueError(f"dstate must be {(B, H, hd, hd)} on {r.device}, got "
                         f"{tuple(dstate.shape)} on {dstate.device}")
    lib = _build.load("wkv6_bwd")
    geometry = (lib.wkv6_bwd_chunk(), lib.wkv6_bwd_slice(), lib.wkv6_bwd_cols(),
                lib.wkv6_bwd_rows(hd))
    mine = (BWD_CHUNK, BWD_SLICE, BWD_COLS, BWD_ROWS[hd])
    if geometry != mine:
        raise RuntimeError(f"csrc/wkv6_bwd.cu has (chunk, slice, cols, rows) {geometry}, "
                           f"this module {mine}")
    # the kernel stages by 16-byte copies and loads float4 rows of dstate
    r, k, v, w, u, do = (t.contiguous() if t.data_ptr() % 16 == 0
                         else t.clone(memory_format=torch.contiguous_format)
                         for t in (r, k, v, w, u, do.to(r.dtype)))
    if dstate is not None:
        dstate = dstate.float().contiguous()
        if dstate.data_ptr() % 16:
            dstate = dstate.clone()
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.empty_like(u)
    if B == 0 or H == 0:
        return dr, dk, dv, dw, du.zero_()
    # a float4 of each of a thread's rows at the start of every chunk
    geo = wkv6_bwd_grid(hd, B, H)
    f32 = dict(dtype=torch.float32, device=r.device)
    ckpt = torch.empty(geo["grid"][0] * geo["grid"][1] * -(-S // BWD_CHUNK) * BWD_ROWS[hd]
                       * geo["threads"] * 4, **f32)
    du_part = torch.empty(B * H * hd, **f32)
    fn = _build.function("wkv6_bwd", "wkv6_bwd_launch", [
        *[ctypes.c_void_p] * 14, *[ctypes.c_int] * 5, ctypes.c_void_p,
    ])
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                do.data_ptr(), None if dstate is None else dstate.data_ptr(),
                ckpt.data_ptr(), du_part.data_ptr(), dr.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
                _DTYPES[r.dtype], B, S, H, hd, stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: CUDA error {rc}")
    wkv6_bwd.launches += 1
    return dr, dk, dv, dw, du


def wkv6_bwd(r, k, v, w, u, do, dstate=None):
    """(dr, dk, dv, dw, du) of :func:`wkv6` at the output gradient ``do``
    and the final state's gradient ``dstate`` (None: zeros); ``du`` summed
    over batch and time. On a CUDA tensor it launches ``csrc/wkv6_bwd.cu``
    (float32 arithmetic, no atomics: every call gives the same bits; the
    slices' row sums meet in the cluster's shared memory, du's batch rows in
    a small second kernel); on a CPU tensor it takes :func:`wkv6_bwd_plain`.
    ``wkv6_bwd.launches`` counts the CUDA launches.

    Bound: operations, about 14 flops per (token, i, j) at the float32
    rate outside the tensor cores."""
    if r.device.type == "cpu":
        return wkv6_bwd_plain(r, k, v, w, u, do, dstate)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_bwd runs on cuda or cpu, not {r.device}")
    return _launch_bwd(r, k, v, w, u, do, dstate)


wkv6_bwd.launches = 0


class WKV6(torch.autograd.Function):
    """The forward kernel and, for the gradient, the backward kernel, on
    CUDA tensors."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        o, state = _launch(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        return o, state

    @staticmethod
    def backward(ctx, do, dstate):
        r, k, v, w, u = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        return wkv6_bwd(r, k, v, w, u, do, dstate)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor):
    """RWKV6 WKV from a zero state.

    ``r``, ``k``, ``v``, ``w`` (B, S, H, hd), ``u`` (H, hd). On the card r,
    k and v are bfloat16 or float32 (one dtype), w and u float32 and ``hd``
    in :data:`HEAD_DIMS`. Returns ``(o (B, S, H, hd) in r's dtype, final
    state (B, H, hd, hd) float32)``, state indexed ``[b, h, k-index,
    v-index]``.

    ``wkv6.launches`` counts the CUDA kernel's launches; the CPU path never
    adds to it. Where autograd records (grad mode on and an input that
    requires a gradient) the CUDA path goes through :class:`WKV6`, whose
    backward is the backward kernel.
    """
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u)):
        return WKV6.apply(r, k, v, w, u)
    return _launch(r, k, v, w, u)


wkv6.launches = 0
