"""The packed LSTM time loop, forward and backward: CUDA kernel wrappers,
their plain versions, and the autograd function over both.

Kernels: ``csrc/lstm_fwd.cu`` (``ss_lstm_fwd``), which replaces the TPU
kernel ``ss_asr_tpu/ops/pallas/lstm.py::_make_fwd_kernel`` (and, with both
directions of a layer in one launch, ``bilstm.py::_bi_fwd_kernel``), and
``csrc/lstm_bwd.cu`` (``ss_lstm_bwd``), which replaces
``::_make_bwd_kernel`` and, with both directions of a layer in one launch,
``ss_asr_tpu/ops/pallas/bilstm.py::_bi_bwd_kernel``.  The sources' headers
say what bounds them on an H100 and how their design answers that.

``lstm_fwd`` and ``lstm_bwd`` route by device: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs ``lstm_seq_plain`` /
``lstm_bwd_plain``, the time loops in PyTorch ops that the kernels are held
against.  ``LSTMSeq`` is the differentiable loop (the port of
``lstm_seq_pallas_vjp``): its forward is ``lstm_fwd``, its backward
``lstm_bwd`` plus the ``W_hh`` gradient as one product outside the kernel.
The kernels write through raw pointers, so autograd cannot see them: a
direct ``lstm_fwd`` call on CUDA tensors that need a gradient raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ss_asr_tpu_torch.ops.kernels import build

#: kernel launches made by ``lstm_fwd`` / ``lstm_bwd`` (one per call on CUDA
#: tensors); ``lstm_fwd_cluster`` / ``lstm_bwd_cluster`` count those that took
#: the cluster route
LAUNCHES = {"lstm_fwd": 0, "lstm_fwd_cluster": 0, "lstm_bwd": 0, "lstm_bwd_cluster": 0}

#: what the cluster routes of ``csrc/lstm_fwd.cu`` and ``csrc/lstm_bwd.cu``
#: are sized by: the shared memory a block can use on an H100 (bytes), the
#: cluster sizes and the tile heights (batch rows a cluster) they are written
#: for, and the clusters of each size that an H100 SXM (132 SMs, a CTA of
#: either kernel fills one) holds at once, as
#: ``cudaOccupancyMaxActiveClusters`` counts them (``resident_clusters``)
SMEM_BYTES = 227 * 1024
CLUSTER_SIZES = (1, 2, 4, 8)
TILE_ROWS = (4, 5, 6, 8)
CARD_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}


def cluster_smem_bytes(H: int, C: int, R: int) -> int:
    """Shared memory of one CTA of the cluster route (``cluster_plan`` in
    ``csrc/lstm_bwd.cu``): the resident ``[H, 4H/C]`` slice of ``W_hh`` at a
    row pitch of 4H/C + 4, double-buffered step operands (h_p, gx, c_t, c_p,
    dy), the dc carry, dgates, the partial gate sums (4 pairs of k-slices),
    the CTA's partial of the carry and the double-buffered reduce-scatter
    slots."""
    Hc = H // C
    LC = 4 * Hc
    floats = (H * (LC + 4) + 2 * R * H + 2 * R * LC + 3 * 2 * R * Hc + R * Hc + R * LC
              + 4 * R * LC + R * H + 2 * C * R * Hc + R)
    return 4 * floats


def cluster_serves(H: int, C: int, R: int = 8) -> bool:
    """Whether a cluster of C CTAs with tiles of R rows serves hidden size H:
    each CTA's H/C units a whole number of warps, H a multiple of 64 (the
    carry product gives a thread 8 units and a warp 8 such threads), and the
    slice and the buffers inside one block's shared memory."""
    return (C in CLUSTER_SIZES and R in TILE_ROWS and H % C == 0 and H // C > 0
            and (H // C) % 32 == 0 and H % 64 == 0
            and cluster_smem_bytes(H, C, R) <= SMEM_BYTES)


def fwd_cluster_smem_bytes(H: int, C: int, R: int) -> int:
    """Shared memory of one CTA of the forward's cluster route (``fwd_plan``
    in ``csrc/lstm_fwd.cu``): the resident ``[H, 4H/C]`` slice of ``W_hh``,
    the double-buffered gathered h, a ring of three steps of gx columns, the
    partial gate sums (8 pairs of k-slices), the cell carry and the tile's
    lengths."""
    Hc = H // C
    LC = 4 * Hc
    return 4 * (H * LC + 2 * R * H + 3 * R * LC + 8 * R * LC + R * Hc + R)


def fwd_cluster_serves(H: int, C: int, R: int = 8) -> bool:
    """Whether the forward's cluster route serves hidden size H with C CTAs
    and tiles of R rows: each CTA's H/C units a whole number of warps (its
    4H/C gate columns in groups of 128), H a multiple of 64 (16 k-slices of
    float4s), and the slice and the buffers inside one block's shared
    memory."""
    return (C in CLUSTER_SIZES and R in TILE_ROWS and H % C == 0 and H // C > 0
            and (H // C) % 32 == 0 and H % 64 == 0
            and fwd_cluster_smem_bytes(H, C, R) <= SMEM_BYTES)


def _route(serves, H: int, B: int, D: int) -> Tuple[int, int]:
    """(C, R): C the smallest cluster size that serves H at tiles of 8 rows;
    R the smallest tile height whose clusters are all resident at once, else
    8; (0, 0) where no cluster serves H."""
    for C in CLUSTER_SIZES:
        if serves(H, C):
            fit = [R for R in TILE_ROWS if -(-B // R) * D <= CARD_CLUSTERS[C]]
            return C, (fit[0] if fit else TILE_ROWS[-1])
    return 0, 0


def lstm_fwd_route(H: int, B: int, D: int) -> Tuple[int, int]:
    """The route of ``lstm_fwd`` on the card, from the shape alone ->
    ``(C, R)``: a thread-block cluster of C CTAs per (direction, tile of R
    batch rows) with ``W_hh`` resident in shared memory and ``h_t``
    all-gathered through distributed shared memory, C the smallest of 1, 2,
    4, 8 that serves H; or ``(0, 0)``, the streaming kernel, where none does.
    R is the smallest of 4, 5, 6, 8 whose clusters are all resident at once
    on the card (15 clusters of 8 CTAs): B = 8 or 16 take tiles of 4 rows,
    the training batch B = 32 tiles of 5."""
    return _route(fwd_cluster_serves, H, B, D)


def lstm_bwd_route(H: int, B: int, D: int) -> Tuple[int, int]:
    """The route of ``lstm_bwd`` on the card, from the shape alone ->
    ``(C, R)``: a thread-block cluster of C CTAs per (direction, tile of R
    batch rows) with ``W_hh`` resident in shared memory, C the smallest of 1,
    2, 4, 8 that serves H; or ``(0, 0)``, the streaming kernel, where none
    does (H / C not a multiple of 32, or H above about 350).  R is the
    smallest of 4, 5, 6, 8 whose clusters are all resident at once on the
    card (a step's time grows with R, but a second wave doubles it): the
    flagship's B = 32 takes tiles of 5 rows, 14 clusters where 15 fit."""
    return _route(cluster_serves, H, B, D)


def lstm_seq_plain(
    gx: torch.Tensor, whh: torch.Tensor, lengths: torch.Tensor, reverse: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed LSTM loop in plain PyTorch.

    gx [T, B, 4H] time-major ``x @ W_ih + b``; whh [H, 4H] (``x @ W``
    layout); lengths [B].  Returns ``(y, cs)``, both [T, B, H]: ``y`` is
    zero past each length, ``cs`` is the (frozen) cell carry after each
    step.  ``reverse`` walks t = T-1 .. 0."""
    T, B, G = gx.shape
    H = G // 4
    h = gx.new_zeros(B, H)
    c = gx.new_zeros(B, H)
    y = gx.new_zeros(T, B, H)
    cs = gx.new_zeros(T, B, H)
    lengths = lengths.to(gx.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = (gx[t] + h @ whh).chunk(4, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        valid = (t < lengths)[:, None]
        h = torch.where(valid, h2, h)
        c = torch.where(valid, c2, c)
        y[t] = torch.where(valid, h2, torch.zeros_like(h2))
        cs[t] = c
    return y, cs


def predecessors(a: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The processing predecessor of every step of a [T, ...] stream: t-1
    for the forward direction, t+1 for the reversed one, zero at the
    sequence edge.  Exact for y and cs: past a length y is zero and cs
    holds the frozen carry, which is zero where the reversed direction
    starts (``ops/pallas/lstm.py:564-570``)."""
    z = torch.zeros_like(a[:1])
    return torch.cat([a[1:], z]) if reverse else torch.cat([z, a[:-1]])


def lstm_bwd_plain(
    gx: torch.Tensor, whh: torch.Tensor, lengths: torch.Tensor, y: torch.Tensor,
    cs: torch.Tensor, dy: torch.Tensor, reverse: bool = False,
) -> torch.Tensor:
    """Adjoint of ``lstm_seq_plain`` for one direction -> dgx [T, B, 4H].

    The gates are recomputed from gx and the predecessor state; the (dh,
    dc) carries walk opposite to the forward and hold still past each
    length, where dgates is zero (the TPU kernel ``_make_bwd_kernel``)."""
    T, B, G = gx.shape
    H = G // 4
    h_prev, c_prev = predecessors(y, reverse), predecessors(cs, reverse)
    gates = gx + h_prev @ whh
    i, f, o = (torch.sigmoid(gates[..., k * H:(k + 1) * H]) for k in (0, 1, 3))
    g = torch.tanh(gates[..., 2 * H:3 * H])
    tanh_c = torch.tanh(cs)
    lengths = lengths.to(gx.device)
    dgx = torch.zeros_like(gx)
    dh_c = gx.new_zeros(B, H)
    dc_c = gx.new_zeros(B, H)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        dh = dh_c + dy[t]
        do = dh * tanh_c[t]
        dct = dh * o[t] * (1.0 - tanh_c[t] * tanh_c[t]) + dc_c
        dgates = torch.cat([dct * g[t] * i[t] * (1.0 - i[t]),
                            dct * c_prev[t] * f[t] * (1.0 - f[t]),
                            dct * i[t] * (1.0 - g[t] * g[t]),
                            do * o[t] * (1.0 - o[t])], dim=-1)
        valid = (t < lengths)[:, None]
        dgates = torch.where(valid, dgates, torch.zeros_like(dgates))
        dh_c = torch.where(valid, dgates @ whh.t(), dh_c)
        dc_c = torch.where(valid, dct * f[t], dc_c)
        dgx[t] = dgates
    return dgx


def _check(name: str, gx: torch.Tensor, whh: torch.Tensor, lengths: torch.Tensor,
           reverse: Sequence[bool]) -> None:
    D, T, B, G = gx.shape
    H = G // 4
    if whh.shape != (D, H, G) or len(reverse) != D or lengths.shape != (B,):
        raise ValueError(
            f"{name}: gx {tuple(gx.shape)}, whh {tuple(whh.shape)}, "
            f"lengths {tuple(lengths.shape)}, {len(reverse)} directions")
    if gx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {gx.device}")


def _operands(name: str, dev: torch.device, **tensors) -> None:
    for key, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: {key} must be contiguous float32 on {dev}")


def lstm_fwd(
    gx: torch.Tensor, whh: torch.Tensor, lengths: torch.Tensor, reverse: Sequence[bool],
    route: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """D independent packed LSTM loops (D = directions of a layer).

    gx [D, T, B, 4H] float32; whh [D, H, 4H] float32; lengths [B];
    ``reverse[d]`` makes direction d walk time newest-first.  Returns
    ``(y, cs)``, each [D, T, B, H].  Differentiate through ``LSTMSeq``.
    On the card ``lstm_fwd_route`` picks the kernel's route from the shape;
    ``route=(C, R)`` asks for one that serves the shape instead (the tests
    hold every cluster size), ``(0, 0)`` for the streaming kernel."""
    _check("lstm_fwd", gx, whh, lengths, reverse)
    D, T, B, G = gx.shape
    H = G // 4
    if gx.device.type == "cpu":
        outs = [lstm_seq_plain(gx[d], whh[d], lengths, reverse[d]) for d in range(D)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    if torch.is_grad_enabled() and (gx.requires_grad or whh.requires_grad):
        raise RuntimeError("lstm_fwd: the CUDA kernel is invisible to autograd; "
                           "differentiate through LSTMSeq.apply")
    _operands("lstm_fwd", gx.device, gx=gx, whh=whh)
    lengths = lengths.to(device=gx.device, dtype=torch.int32).contiguous()
    y = torch.empty(D, T, B, H, device=gx.device, dtype=torch.float32)
    cs = torch.empty_like(y)
    C, R = lstm_fwd_route(H, B, D) if route is None else route
    if C and not fwd_cluster_serves(H, C, R):
        raise ValueError(f"lstm_fwd: no cluster of {C} CTAs with tiles of {R} rows serves H={H}")
    if T == 0 or B == 0:
        return y, cs
    lib = build.load_library()
    rev_bits = sum(1 << d for d in range(D) if reverse[d])
    err = lib.ss_lstm_fwd(
        gx.data_ptr(), whh.data_ptr(), lengths.data_ptr(), y.data_ptr(), cs.data_ptr(),
        D, T, B, H, rev_bits, C, R, gx.device.index or 0,
        torch.cuda.current_stream(gx.device).cuda_stream,
    )
    build.check(err, "ss_lstm_fwd")
    build.count_launch(LAUNCHES, "lstm_fwd")
    if C:
        build.count_launch(LAUNCHES, "lstm_fwd_cluster")
    return y, cs


def resident_clusters(H: int, C: int, R: int, device: torch.device,
                      forward: bool = False) -> int:
    """How many clusters of the backward's (``forward``: the forward's)
    cluster route the card holds at once (``cudaOccupancyMaxActiveClusters``):
    what ``CARD_CLUSTERS`` records."""
    import ctypes

    if not (fwd_cluster_serves if forward else cluster_serves)(H, C, R):
        raise ValueError(f"resident_clusters: no cluster of {C} CTAs with tiles of {R} rows "
                         f"serves H={H}")
    n = ctypes.c_int(0)
    lib = build.load_library()
    index, out = torch.device(device).index or 0, ctypes.addressof(n)
    if forward:
        err = lib.ss_lstm_fwd_resident_clusters(H, C, R, index, out)
        build.check(err, "ss_lstm_fwd_resident_clusters")
    else:
        err = lib.ss_lstm_bwd_resident_clusters(H, C, R, index, out)
        build.check(err, "ss_lstm_bwd_resident_clusters")
    return n.value


def lstm_bwd(
    gx: torch.Tensor, whh: torch.Tensor, lengths: torch.Tensor, y: torch.Tensor,
    cs: torch.Tensor, dy: torch.Tensor, reverse: Sequence[bool],
    route: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adjoint of ``lstm_fwd`` for D directions -> ``(dgx [D, T, B, 4H],
    dwhh [D, H, 4H])``.  y, cs are ``lstm_fwd``'s outputs, dy [D, T, B, H]
    the cotangent of y.  dgx comes from the kernel (or its plain version);
    dwhh = sum_t h_prev_t^T dgates_t is one batched product over shifted
    views of y, outside the kernel (``ops/pallas/lstm.py:589-596``).
    On the card ``lstm_bwd_route`` picks the kernel's route from the shape;
    ``route=(C, R)`` asks for one that serves the shape instead (the tests
    hold every cluster size), ``(0, 0)`` for the streaming kernel."""
    _check("lstm_bwd", gx, whh, lengths, reverse)
    D, T, B, G = gx.shape
    H = G // 4
    if not (y.shape == cs.shape == dy.shape == (D, T, B, H)):
        raise ValueError(f"lstm_bwd: y {tuple(y.shape)}, cs {tuple(cs.shape)}, "
                         f"dy {tuple(dy.shape)} do not fit gx {tuple(gx.shape)}")
    if gx.device.type == "cpu":
        dgx = torch.stack([lstm_bwd_plain(gx[d], whh[d], lengths, y[d], cs[d], dy[d], reverse[d])
                           for d in range(D)])
    else:
        dy = dy.contiguous()
        _operands("lstm_bwd", gx.device, gx=gx, whh=whh, y=y, cs=cs, dy=dy)
        lengths = lengths.to(device=gx.device, dtype=torch.int32).contiguous()
        dgx = torch.empty_like(gx)
        C, R = lstm_bwd_route(H, B, D) if route is None else route
        if C and not cluster_serves(H, C, R):
            raise ValueError(f"lstm_bwd: no cluster of {C} CTAs with tiles of {R} rows serves "
                             f"H={H}")
        if T > 0 and B > 0:
            lib = build.load_library()
            rev_bits = sum(1 << d for d in range(D) if reverse[d])
            err = lib.ss_lstm_bwd(
                gx.data_ptr(), whh.data_ptr(), lengths.data_ptr(), y.data_ptr(), cs.data_ptr(),
                dy.data_ptr(), dgx.data_ptr(), D, T, B, H, rev_bits, C, R,
                gx.device.index or 0, torch.cuda.current_stream(gx.device).cuda_stream,
            )
            build.check(err, "ss_lstm_bwd")
            build.count_launch(LAUNCHES, "lstm_bwd")
            if C:
                build.count_launch(LAUNCHES, "lstm_bwd_cluster")
    dwhh = torch.stack([torch.einsum("tbh,tbg->hg", predecessors(y[d], reverse[d]), dgx[d])
                        for d in range(D)])
    return dgx, dwhh


class LSTMSeq(torch.autograd.Function):
    """Differentiable packed LSTM loops: ``LSTMSeq.apply(gx, whh, lengths,
    reverse) -> y [D, T, B, H]`` with the shapes of ``lstm_fwd``.  Gradients
    flow to gx and whh; the forward saves gx, whh, lengths, y and cs."""

    @staticmethod
    def forward(ctx, gx, whh, lengths, reverse):
        gx, whh = gx.contiguous(), whh.contiguous()
        y, cs = lstm_fwd(gx, whh, lengths, reverse)
        ctx.reverse = tuple(reverse)
        ctx.save_for_backward(gx, whh, lengths, y, cs)
        return y

    @staticmethod
    def backward(ctx, dy):
        gx, whh, lengths, y, cs = ctx.saved_tensors
        dgx, dwhh = lstm_bwd(gx, whh, lengths, y, cs, dy, ctx.reverse)
        return dgx, dwhh, None, None
