"""Flash attention of the video and text backbones and of the attention
bench: CUDA kernels + their plain versions.

The port of algonauts2025_tpu/ops/flash_attention.py, every route in one
source, ``csrc/flash_attention.cu``:

- non-causal, no key lengths, a head dim that is not a multiple of 128
  (ViT-G: 8192 tokens, 22 heads of 64): the JAX package's
  ``_bounded_kernel``; the kernel ``flash_forward`` computes the same
  function with the softmax scale folded into q and rounded to q's dtype,
  p rounded to v's dtype before the P.V product and the row sum over that
  rounded p (``bounded_attention_plain``).  It shifts the scores by their
  running maximum, so unlike the TPU kernel's a-priori shift it cannot
  overflow when the scores of a row spread widely.
- every other call (Llama: causal, right-padded key lengths, 24 query heads
  over 8 kv heads of 128): the JAX package's ``_flash_kernel``; the kernel
  ``flash_forward_masked`` scales the fp32 scores, sums fp32 p, rounds p
  to v's dtype for P.V, returns zeros for a row of length 0 and skips the
  key tiles that hold no kept key (``flash_attention_plain``).

Off the dispatch, for the attention bench (``scripts/bench_attn.py``):

- ``fast_flash_attention``: the JAX package's ``_fast_kernel`` (through
  ``_fast_flash``), ``flash_forward``'s numerics with an optional rounding
  of every score to bf16 (``flash_forward_fast``, ``fast_attention_plain``).
- ``flash_attention_packed``: the JAX package's ``_flash_kernel_packed``,
  ``_flash_kernel``'s numerics with no mask for d = 64 and an even head
  count; its head-pair packing into 128 TPU lanes has no counterpart here,
  each head runs on its own (``flash_forward_packed``,
  ``packed_attention_plain``).

The w2v-BERT conformer's self-attention with its clamped relative-key bias
(``relkey_attention``; HF's ``relative_key`` position embeddings) has no TPU
kernel: the JAX package leaves it to XLA.  Its kernel ``flash_relkey_forward``
computes ``RelKeyAttention``'s function at head dim 64 in bf16 with fp32
scores, bias and softmax and the normalised probabilities rounded to bf16
before P.V (``relkey_attention_plain``), sweeping the keys twice: once for
each row's maximum and sum, once for P.V.

Every kernel takes any T (the ragged edge is masked in the kernel), so the
JAX package's q/kv block sizes have no counterpart here.  bf16 runs on the
tensor cores and reads q, k and v through TMA, which needs 16-byte
aligned bases and b, h and t strides in multiples of 8 elements
(``check_tma_layout``); fp32 runs on the CUDA cores and takes any strides.
"""

from __future__ import annotations

import ctypes
import re

import torch

from . import _cuda

__all__ = ["flash_attention", "fast_flash_attention", "flash_attention_packed", "relkey_attention",
           "bounded_attention_plain", "fast_attention_plain", "flash_attention_plain",
           "packed_attention_plain", "relkey_attention_plain", "relative_positions", "check_tma_layout",
           "tc_block", "tc_launch_regs", "tc_instantiation", "TC_INSTANTIATIONS", "check_relkey_inputs",
           "relkey_block", "relkey_tile_kind", "relkey_instantiation", "RELKEY_INSTANTIATIONS", "RELKEY_HEAD_DIM",
           "launch_counts", "recorded_counts"]

#: kernel launches since the last reset, counted where the kernel launches
launch_counts: dict[str, int] = {"flash_attention": 0, "flash_masked": 0, "flash_fast": 0,
                                 "flash_packed": 0, "flash_relkey": 0}
#: launches recorded into a CUDA graph while the current stream captures it
#: (a capture launches nothing): whoever replays the graph adds what its
#: capture recorded to ``launch_counts`` (``features.audio.StageGraphs``)
recorded_counts: dict[str, int] = dict.fromkeys(launch_counts, 0)

_FORWARD = ("flash_attention", "flash_forward", (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_longlong),
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p,
))
_MASKED = ("flash_attention", "flash_forward_masked", (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
))
_FAST = ("flash_attention", "flash_forward_fast", (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_longlong),
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p,
))
_PACKED = ("flash_attention", "flash_forward_packed", _FORWARD[2])
_RELKEY = ("flash_attention", "flash_relkey_forward", (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
))
_MAX_HEAD_DIM = ("flash_attention", "flash_max_head_dim", ())
#: the score dtypes of ``fast_flash_attention`` (``_fast_kernel``'s score_dtype)
_SCORE_DTYPES = (torch.float32, torch.bfloat16)
#: query rows per chunk of the plain version: its fp32 scores are then
#: (B, H, 1024, T), 0.74 GB for 22 heads of 8192 tokens, not 5.9 GB
_PLAIN_ROWS = 1024


def fast_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, score_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(B, H, T, d) exact softmax attention with ``_fast_kernel``'s roundings:
    the scale folded into q and rounded to q's dtype, each fp32 score
    rounded to ``score_dtype``, p rounded to v's dtype before P.V and the
    row sum over that rounded p.

    Computed in chunks of query rows (rows are independent, so chunking
    changes no value) so that the scores of 8192 tokens fit in memory."""
    scale = q.shape[-1] ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for r0 in range(0, q.shape[-2], _PLAIN_ROWS):
        qs = (q[..., r0 : r0 + _PLAIN_ROWS, :].float() * scale).to(q.dtype).float()
        s = torch.matmul(qs, kf.transpose(-1, -2)).to(score_dtype).float()
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(v.dtype).float()
        o = torch.matmul(p, vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out[..., r0 : r0 + _PLAIN_ROWS, :] = o.to(q.dtype)
    return out


def bounded_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, T, d) exact softmax attention with ``flash_forward``'s
    roundings: ``fast_attention_plain`` with fp32 scores."""
    return fast_attention_plain(q, k, v)


def _repeat_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, KVH, T, d) -> (B, heads, T, d): kv head j serves query heads
    j*rep .. j*rep + rep - 1 (``jnp.repeat(x, rep, axis=1)``)."""
    return x if x.shape[1] == heads else x.repeat_interleave(heads // x.shape[1], dim=1)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, H, T, d) masked softmax attention with ``_flash_kernel``'s roundings.

    k and v may have H / rep heads (GQA).  Scores are q.k in fp32 times the
    scale in fp32; masked scores (``col > row`` if causal, ``col >=
    lengths[b]`` if lengths) are -1e30; the row sum is over fp32 p and P.V
    over p rounded to v's dtype; ``acc / max(l, 1e-30)``; a row of length 0
    is zero.  Computed in chunks of query rows, as the bounded version."""
    b, h, t, d = q.shape
    scale = d**-0.5
    kf, vf = _repeat_kv(k, h).float(), _repeat_kv(v, h).float()
    cols = torch.arange(t, device=q.device)
    lens = None if lengths is None else lengths.to(q.device).reshape(b, 1, 1, 1)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for r0 in range(0, t, _PLAIN_ROWS):
        r1 = min(t, r0 + _PLAIN_ROWS)
        s = torch.matmul(q[..., r0:r1, :].float(), kf.transpose(-1, -2)) * scale
        keep = torch.ones((1, 1, r1 - r0, t), dtype=torch.bool, device=q.device)
        if causal:
            keep = keep & (cols <= torch.arange(r0, r1, device=q.device)[:, None])
        if lens is not None:
            keep = keep & (cols < lens)
        s = torch.where(keep, s, -1e30)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.matmul(p.to(v.dtype).float(), vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        if lens is not None:
            o = torch.where(lens > 0, o, 0.0)
        out[..., r0:r1, :] = o.to(q.dtype)
    return out


#: TMA's alignment of a tensor's base address and of its strides, in bytes
_TMA_ALIGN = 16

#: the bf16 kernel's block by the head dim it runs at (csrc/flash_attention.cu,
#: ``tc::Block``): consumer warpgroups of 64 query rows, K/V ring stages, and
#: the registers a consumer and a producer thread keep after setmaxnreg
_TC_BLOCKS = {64: (3, 3, 160, 32), 128: (2, 2, 240, 24)}
_TC_KEYS = 128  # keys per streamed tile
_TC_Q_SLOTS = 2  # q tiles a block holds: this item's and the next one's
#: the registers of an SM, the most a thread may hold, and the dynamic shared
#: memory a block may use on sm_90
SM90_REGISTERS, SM90_MAX_THREAD_REGISTERS, SM90_MAX_SMEM = 65536, 255, 232448


def tc_launch_regs(threads: int) -> int:
    """The registers a thread of a ``threads``-thread block holds at launch
    under ``__launch_bounds__(threads, 1)``: the register file over the
    threads, at most 255, in the multiples of 8 that ptxas allocates."""
    return min(SM90_REGISTERS // threads, SM90_MAX_THREAD_REGISTERS) // 8 * 8


def tc_block(head_dim: int, masked: bool = False) -> dict[str, int]:
    """The block the bf16 kernel launches for ``head_dim`` (1..128; it runs
    at 64 or 128, zero-padded) with masked numerics (``masked``: the
    masked, packed and Llama calls) or unmasked ones: a pure function
    mirroring ``tc::Block``.

    ``smem_bytes`` counts the q slots, ``stages`` K and V tiles (unmasked at
    d = 64, each V tile with a 64-column panel of ones beside it, over
    which P V sums each row of the rounded p), the mbarriers (full / empty
    for each q slot, and for K and for V a stage) and the slack that
    aligns the base to 1024 bytes; ``launch_regs`` is ``tc_launch_regs`` of
    the block, which the setmaxnreg split of the register file must not
    exceed."""
    if not 1 <= head_dim <= 128:
        raise ValueError(f"the bf16 flash kernel takes head dims 1..128, got {head_dim}")
    d = 64 if head_dim <= 64 else 128
    warpgroups, stages, consumer_regs, producer_regs = _TC_BLOCKS[d]
    rows, threads = 64 * warpgroups, 128 * warpgroups + 128
    tile = _TC_KEYS * d * 2
    ones = _TC_KEYS * 128 if d == 64 and not masked else 0
    return {
        "head_dim": d, "warpgroups": warpgroups, "stages": stages, "q_slots": _TC_Q_SLOTS, "rows": rows,
        "threads": threads,
        "smem_bytes": _TC_Q_SLOTS * rows * d * 2 + stages * (2 * tile + ones) + 8 * (2 * _TC_Q_SLOTS + 4 * stages)
        + 1024,
        "consumer_regs": consumer_regs, "producer_regs": producer_regs, "launch_regs": tc_launch_regs(threads),
    }


#: every bf16 instantiation of ``flash_tc_kernel``: (head dim it runs at,
#: masked, bf16 scores), as ``launch_typed`` instantiates them
TC_INSTANTIATIONS = [(d, masked, b16) for d in (64, 128) for masked, b16 in ((0, 0), (0, 1), (1, 0))]


def tc_instantiation(name: str) -> tuple[int, ...]:
    """(head dim, masked, bf16 scores) of a mangled ``flash_tc_kernel`` name:
    its template arguments, as ``TC_INSTANTIATIONS`` lists them."""
    return tuple(int(x) for x in re.findall(r"L[ib](\d+)E", name.split("flash_tc_kernel", 1)[1])[:3])


def check_tma_layout(name: str, shape, strides, data_ptr: int, element_size: int) -> None:
    """Raise ValueError unless TMA can read the (B, H, T, d) tensor ``name``
    as the bf16 kernel maps it: a 16-byte aligned base and b, h and t
    strides that are multiples of 16 bytes (8 bf16 elements).  The stride
    of a dim of size 1 is never used and is not checked.  A pure function
    of the layout: it never copies and never reroutes."""
    if data_ptr % _TMA_ALIGN:
        raise ValueError(f"flash attention kernel: {name} starts at {data_ptr:#x}, not on a "
                         f"{_TMA_ALIGN}-byte boundary, so TMA cannot read it")
    for dim, stride, size in zip("bht", strides[:3], shape[:3]):
        if size > 1 and stride * element_size % _TMA_ALIGN:
            raise ValueError(f"flash attention kernel: {name}'s {dim} stride {stride} is not a multiple "
                             f"of {_TMA_ALIGN // element_size} elements, so TMA cannot read it")


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gqa: bool) -> None:
    """The kernels' common checks: CUDA, fp32/bf16, (B, H, T, d) q with k
    and v of q's shape (or, with ``gqa``, of H / rep heads), unit stride on
    the head dim, a head dim the kernel takes, and for bf16 the layout TMA
    reads."""
    _cuda.check_cuda("flash attention", q=q, k=k, v=v)
    kv_heads = k.shape[1] if gqa and k.dim() == 4 else q.shape[1]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in _cuda.DTYPE_CODES:
            raise TypeError(f"flash attention kernel takes float32 or bfloat16, {name} is {x.dtype}")
        want = q.shape if name == "q" else (*q.shape[:1], kv_heads, *q.shape[2:])
        if x.dim() != 4 or x.shape != want or q.shape[1] % kv_heads:
            raise ValueError(
                f"flash attention kernel wants q of (B, H, T, d) and k, v of "
                f"{'(B, H / rep, T, d)' if gqa else 'the same shape'}, got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
            )
        if x.stride(-1) != 1:
            raise ValueError(f"flash attention kernel needs a unit stride on the head dim of {name}")
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError("flash attention kernel: q, k, v differ in dtype or device")
        if x.dtype == torch.bfloat16:
            check_tma_layout(name, x.shape, x.stride(), x.data_ptr(), x.element_size())
    b, h, t, d = q.shape
    max_d = _cuda.function(*_MAX_HEAD_DIM)()
    if t < 1 or b * h < 1 or not 1 <= d <= max_d:
        raise ValueError(
            f"flash attention kernel: shape {tuple(q.shape)}; it takes head dims "
            f"1..{max_d} and a non-empty T"
        )
    if b * h > 65535:
        raise ValueError(f"flash attention kernel: B*H={b * h} exceeds the grid's 65535")


def _output_and_strides(q, k, v):
    """The output, allocated in (B, T, H, d) order and viewed as (B, H, T, d)
    (the caller's merge of the heads is free), and the (b, h, t) strides of
    q, k, v and o for the C interface."""
    b, h, t, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
    return out, strides


def _launch(entry: tuple, counter: str, q, k, v, gqa: bool, *args) -> torch.Tensor:
    """Launch ``entry`` of csrc/flash_attention.cu on the current stream
    (``args`` follow the strides in its C interface) and count it.

    q, k and v may be strided views as long as the head dim is contiguous;
    with ``gqa``, k and v may have H / rep heads."""
    _check_qkv(q, k, v, gqa)
    out, strides = _output_and_strides(q, k, v)
    with torch.cuda.device(q.device):
        err = _cuda.function(*entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, *args,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{counter} kernel launch failed: CUDA error {err} "
                           f"(shape {tuple(q.shape)}, kv heads {k.shape[1]})")
    launch_counts[counter] += 1
    return out


def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``flash_forward``: the bounded kernel's function."""
    b, h, t, d = q.shape
    return _launch(_FORWARD, "flash_attention", q, k, v, False,
                   b, h, t, d, _cuda.DTYPE_CODES[q.dtype], d**-0.5)


def _flash_masked_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, lengths: torch.Tensor | None
) -> torch.Tensor:
    """``flash_forward_masked``; k and v may have H / rep heads."""
    b, h, t, d = q.shape
    lens = None
    if lengths is not None:
        if lengths.shape != (b,):
            raise ValueError(f"flash attention kernel: lengths of shape {tuple(lengths.shape)}, want ({b},)")
        lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    return _launch(_MASKED, "flash_masked", q, k, v, True,
                   None if lens is None else lens.data_ptr(), b, h, k.shape[1], t, d,
                   _cuda.DTYPE_CODES[q.dtype], int(causal), d**-0.5)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, H, T, d) attention without materialized scores.

    Routes as the JAX package does: non-causal, no ``lengths`` and ``d %
    128 != 0`` to the bounded kernel; every other call (``causal``
    restricts to the lower triangle, ``lengths`` (B,) masks right-padded
    keys per batch row; k and v may have H / rep heads) to the masked
    kernel.  CUDA tensors launch the kernel, CPU tensors run its plain
    version."""
    bounded = not causal and lengths is None and q.shape[-1] % 128
    if q.device.type == "cpu":
        if bounded:
            return bounded_attention_plain(q, k, v)
        return flash_attention_plain(q, k, v, causal, lengths)
    if bounded:
        return _flash_cuda(q, k, v)
    return _flash_masked_cuda(q, k, v, causal, lengths)


def fast_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, score_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(B, H, T, d) non-causal attention with ``_fast_kernel``'s numerics
    (the scale folded into a rounded q, the row sum over p rounded to v's
    dtype), each score rounded to ``score_dtype`` (float32 or bfloat16)
    first.  CUDA tensors launch ``flash_forward_fast``, CPU tensors run
    ``fast_attention_plain``."""
    if score_dtype not in _SCORE_DTYPES:
        raise ValueError(f"fast_flash_attention: score_dtype {score_dtype}, want float32 or bfloat16")
    if q.device.type == "cpu":
        return fast_attention_plain(q, k, v, score_dtype)
    b, h, t, d = q.shape
    return _launch(_FAST, "flash_fast", q, k, v, False, b, h, t, d, _cuda.DTYPE_CODES[q.dtype],
                   int(score_dtype == torch.bfloat16), d**-0.5)


def _check_packed(q: torch.Tensor) -> None:
    """``flash_attention_packed``'s contract: head dim 64, an even head count."""
    if q.dim() != 4 or q.shape[-1] != 64 or q.shape[1] % 2:
        raise ValueError(f"flash_attention_packed takes (B, H, T, 64) with H even, got {tuple(q.shape)}")


def packed_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 64) non-causal attention with ``_flash_kernel_packed``'s
    numerics, which are ``flash_attention_plain``'s with no mask."""
    _check_packed(q)
    return flash_attention_plain(q, k, v)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 64) non-causal attention for an even head count, with
    ``_flash_kernel``'s numerics (fp32 scale on the scores, the row sum
    over fp32 p).  Raises ValueError unless d == 64 and H is even, as the
    JAX version does.  CUDA tensors launch ``flash_forward_packed``, CPU
    tensors run ``packed_attention_plain``."""
    _check_packed(q)
    if q.device.type == "cpu":
        return packed_attention_plain(q, k, v)
    b, h, t, d = q.shape
    return _launch(_PACKED, "flash_packed", q, k, v, False, b, h, t, d, _cuda.DTYPE_CODES[q.dtype],
                   d**-0.5)


def relative_positions(t: int, left: int, right: int, device=None) -> torch.Tensor:
    """(T, T) int64 index of the distance table: clamp(r - l, -left, right) + left."""
    pos = torch.arange(t, device=device)
    return torch.clamp(pos[None, :] - pos[:, None], -left, right) + left


def relkey_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    table: torch.Tensor,
    lengths: torch.Tensor | None = None,
    left: int = 64,
    right: int = 8,
) -> torch.Tensor:
    """(B, H, T, hd) self-attention with a clamped relative-distance key bias
    (HF modeling_wav2vec2_bert.py:308-320), ``RelKeyAttention``'s arithmetic:
    fp32 scores q k^T / sqrt(hd) plus the bias q . table[clamp(r - l, -left,
    right) + left] / sqrt(hd), where keys r >= lengths[b] get -1e30 more,
    the softmax in fp32 rounded to v's dtype, then P.V in v's dtype."""
    b, t, hd = q.shape[0], q.shape[2], q.shape[-1]
    qf = q.float()
    scores = torch.matmul(qf, k.float().transpose(-1, -2)) / hd**0.5
    # project q onto the small distance table, then place the clamped
    # diagonals: rel[b, h, l, r] = qd[b, h, l, index[l, r]]
    qd = torch.matmul(qf, table.float().T)  # (B, H, T, n_pos)
    rel = torch.take_along_dim(qd, relative_positions(t, left, right, device=q.device)[None, None], dim=-1)
    scores = scores + rel / hd**0.5
    if lengths is not None:
        keep = torch.arange(t, device=q.device) < lengths.to(q.device).reshape(b, 1, 1, 1)
        scores = scores + torch.where(keep, 0.0, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


#: the relative-key kernel's block (csrc/flash_attention.cu, namespace rk):
#: consumer warpgroups of 64 query rows, K/V ring stages, q slots, the most
#: rows of the distance table, and the registers a consumer and a producer
#: thread keep after setmaxnreg
_RK_GROUPS, _RK_RING, _RK_SLOTS, _RK_MAX_POS = 2, 4, 2, 80
_RK_CONSUMER_REGS, _RK_PRODUCER_REGS = 240, 24
#: the head dim the relative-key kernel runs at
RELKEY_HEAD_DIM = 64


def relkey_block() -> dict[str, int]:
    """The block ``flash_relkey_kernel`` launches: a pure function mirroring
    the constants of ``namespace rk``.  ``smem_bytes`` counts the q slots,
    the K and V ring, the fp32 distance table (``max_pos`` rows of 64), each
    consumer warpgroup's q.E rows (``qd_stride`` floats a row), the
    mbarriers (full / empty for each q slot, and for K and for V a stage)
    and the slack that aligns the base to 1024 bytes."""
    rows, threads = 64 * _RK_GROUPS, 128 * _RK_GROUPS + 128
    tile = _TC_KEYS * 128
    qd_stride = _RK_MAX_POS + 1
    return {
        "warpgroups": _RK_GROUPS, "stages": _RK_RING, "q_slots": _RK_SLOTS, "rows": rows, "threads": threads,
        "max_pos": _RK_MAX_POS, "qd_stride": qd_stride,
        "smem_bytes": _RK_SLOTS * rows * 128 + 2 * _RK_RING * tile + _RK_MAX_POS * 64 * 4
        + _RK_GROUPS * 64 * qd_stride * 4 + 8 * (2 * _RK_SLOTS + 4 * _RK_RING) + 1024,
        "consumer_regs": _RK_CONSUMER_REGS, "producer_regs": _RK_PRODUCER_REGS,
        "launch_regs": tc_launch_regs(threads),
    }


def relkey_tile_kind(q0: int, k0: int, left: int, right: int) -> str:
    """How ``flash_relkey_kernel`` biases the tile of query rows q0 .. q0 +
    63 and keys k0 .. k0 + 127 (``rk::tile_kind``): "left" when every
    distance r - l is at most -left (each row adds its first q.E value),
    "right" when every one is at least ``right`` (its last), else "band"
    (each score gathers its own)."""
    if k0 + _TC_KEYS - 1 - q0 <= -left:
        return "left"
    if k0 - (q0 + 63) >= right:
        return "right"
    return "band"


#: every instantiation of ``flash_relkey_kernel``: (head dim,)
RELKEY_INSTANTIATIONS = [(RELKEY_HEAD_DIM,)]


def relkey_instantiation(name: str) -> tuple[int, ...]:
    """(head dim,) of a mangled ``flash_relkey_kernel`` name: its template
    argument, as ``RELKEY_INSTANTIATIONS`` lists it."""
    return tuple(int(x) for x in re.findall(r"L[ib](\d+)E", name.split("flash_relkey_kernel", 1)[1])[:1])


def check_relkey_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
                 lengths: torch.Tensor | None, left: int, right: int) -> None:
    """Raise ValueError unless ``flash_relkey_kernel`` takes the call: bf16 q,
    k, v of one (B, H, T, 64) shape with a unit stride on the head dim, in
    the layout TMA reads; a (left + right + 1, 64) table of at most
    ``relkey_block()["max_pos"]`` rows; (B,) lengths.  A pure function of
    shapes, dtypes and layouts: it never copies and never launches."""
    b, h, t, d = q.shape if q.dim() == 4 else (0, 0, 0, 0)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16 or x.shape != q.shape or x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"relative-key attention kernel wants bf16 q, k, v of one (B, H, T, 64) shape with a "
                             f"unit stride on the head dim; {name} is {x.dtype} {tuple(x.shape)} strides {x.stride()}")
        check_tma_layout(name, x.shape, x.stride(), x.data_ptr(), x.element_size())
    if d != RELKEY_HEAD_DIM or t < 1 or b * h < 1:
        raise ValueError(f"relative-key attention kernel runs at head dim {RELKEY_HEAD_DIM} over a non-empty T, "
                         f"got {tuple(q.shape)}")
    n_pos = left + right + 1
    if left < 0 or right < 0 or n_pos > _RK_MAX_POS or tuple(table.shape) != (n_pos, d):
        raise ValueError(f"relative-key attention kernel: table of shape {tuple(table.shape)} for left {left}, "
                         f"right {right}; it takes ({n_pos}, {d}) with left, right >= 0 and at most "
                         f"{_RK_MAX_POS} rows")
    if lengths is not None and tuple(lengths.shape) != (b,):
        raise ValueError(f"relative-key attention kernel: lengths of shape {tuple(lengths.shape)}, want ({b},)")


def _relkey_cuda(q, k, v, table, lengths, left, right) -> torch.Tensor:
    """``flash_relkey_forward`` on the current stream, counted (in
    ``recorded_counts`` while the stream captures a graph)."""
    _cuda.check_cuda("relative-key attention", q=q, k=k, v=v, table=table,
                     **({} if lengths is None else {"lengths": lengths}))
    check_relkey_inputs(q, k, v, table, lengths, left, right)
    b, h, t, d = q.shape
    table = table.to(torch.float32).contiguous()
    lens = None if lengths is None else lengths.to(dtype=torch.int32).contiguous()
    out, strides = _output_and_strides(q, k, v)
    with torch.cuda.device(q.device):
        err = _cuda.function(*_RELKEY)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, table.data_ptr(),
            None if lens is None else lens.data_ptr(), b, h, t, d, left + right + 1, left,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_relkey kernel launch failed: CUDA error {err} (shape {tuple(q.shape)})")
    (recorded_counts if torch.cuda.is_current_stream_capturing() else launch_counts)["flash_relkey"] += 1
    return out


def relkey_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    table: torch.Tensor,
    lengths: torch.Tensor | None = None,
    left: int = 64,
    right: int = 8,
) -> torch.Tensor:
    """(B, H, T, hd) self-attention with the clamped relative-distance key
    bias of ``table`` (left + right + 1, hd) over the keys r < lengths[b]
    (every key without ``lengths``).  CPU tensors run
    ``relkey_attention_plain``; CUDA tensors launch ``flash_relkey_forward``
    (bf16 at hd = 64, in the TMA layout, ``check_relkey_inputs``) or
    raise.  The output is (B, T, H, hd) memory seen as (B, H, T, hd), so
    merging the heads is free.  A batch row of length 0 gives zeros on the card (the
    plain version's softmax over no key spreads evenly instead)."""
    if q.device.type == "cpu":
        return relkey_attention_plain(q, k, v, table, lengths, left, right)
    return _relkey_cuda(q, k, v, table, lengths, left, right)
