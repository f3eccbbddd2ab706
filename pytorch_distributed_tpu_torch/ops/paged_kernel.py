"""Paged single-query decode attention: the Hopper kernels and their
plain version.

The port of the JAX package's ``ops/paged_kernel.py`` (the Pallas kernels
``_paged_kernel``, K3, and ``_paged_kernel_q8``, K4). Each batch row's K/V
lives in fixed-size pages of a shared pool ``[P, page, Hkv, D]``
addressed through a per-row block table; one query token per row attends
over keys ``0..lengths[b]`` (inclusive — ``lengths`` is the row's query
position). With ``k_scales``/``v_scales`` the pages are int8 and each
token's K and V carry one f32 scale per KV head (``ops/quant.quantize_kv``).

- ``paged_decode_attention`` is the entry point. On a CUDA tensor it
  launches the hand-written kernel in ``csrc/paged_attention.cu`` (K3, or
  K4 for int8 pages; built at first use, ``ops/_build.py``) or raises; on
  a CPU tensor, and only there, it runs
  ``paged_decode_attention_reference``.
- ``paged_decode_attention_reference`` is the plain PyTorch version:
  ``gather_attention`` (each row's pages gathered into a contiguous view,
  int8 pages dequantized to q's dtype, then the masked softmax — the one
  plain paged attention of the port, which the forward pass also runs
  for prefill) at one query token, as the JAX package's reference is.
- ``launches`` (K3) and ``launches_q8`` (K4) count kernel launches (CPU
  calls never bump them), so a run can show that its decode steps went
  through the kernel. They are bumped under a lock (``_count_launch``), so
  engines stepped on several threads (the HTTP server's drive thread, a
  router's ``parallel_step``) lose no count.
- ``_split_plan`` is how the kernel cuts a row's keys into chunks, one
  CTA each, and ``paged_decode_attention_split_reference`` restates the
  kernel's arithmetic on that partition (per-chunk f32 softmax states in
  base 2, combined in split order) for the CPU tests; nothing on the
  serving path calls it.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from pytorch_distributed_tpu_torch.ops.quant import dequantize_kv

NEG_INF = -1e30  # finite mask: -inf would NaN a fully masked softmax

# Kernel launches since import (or since a caller last reset them): K3
# (pages in q's dtype) and K4 (int8 pages).
launches = 0
launches_q8 = 0
_count_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)

# The split plan: a chunk holds CHUNK_K_BYTES of K rows per KV head — the
# keys a CTA's 8 warps load in one round of four 16-byte loads per lane:
# 128 keys of bf16 at head_dim 64, 256 of int8 — rounded up to whole pages
# and capped at the _MAX_CHUNK_PAGES table entries a CTA holds
# (``kMaxChunkPages`` in the source).
CHUNK_K_BYTES = 16384
_MAX_CHUNK_PAGES = 64

# One workspace per (device, stream), grown on demand: f32 partials and
# int32 counters that the kernel leaves at 0. Launches on one stream run in
# order and share their stream's workspace; launches on two streams of one
# card may run at once, so each stream has its own. A workspace is
# allocated (and regrown) while its stream is current, so the caching
# allocator hands a freed one out again only in that stream's order. The
# key's stream is the raw ``cuda_stream`` handle (None on the CPU).
_workspaces: dict[tuple[torch.device, int | None],
                  tuple[torch.Tensor, torch.Tensor]] = {}


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor):
    """[P, page, ...] pool + [B, n_pages] tables -> the [B, n_pages*page,
    ...] contiguous per-row view (unallocated entries point at the
    scratch page, whose contents the length mask excludes)."""
    b, n_pages = block_tables.shape
    page = pool.shape[1]
    return pool[block_tables.long()].reshape(
        (b, n_pages * page) + tuple(pool.shape[2:])
    )


def gather_attention(q, k_pages, v_pages, block_tables, pos,
                     k_scales=None, v_scales=None) -> torch.Tensor:
    """q [B, T, H, D] at positions pos[b]..pos[b]+T-1 against paged pools
    [P, page, Hkv, D]: gather each row's page view (int8 pages with their
    [P, page, Hkv] scale pools are dequantized to q's dtype, as the JAX
    package does), then the dense masked softmax with f32 scores (key j
    of row b is valid iff j <= pos[b] + i). Returns [B, T, H, D] in the
    (dequantized) pool dtype. The plain attention of every paged step:
    prefill chunks, the gather decode path, and (at T = 1) the kernels'
    plain version."""
    ck = gather_pages(k_pages, block_tables)
    cv = gather_pages(v_pages, block_tables)
    if k_scales is not None:
        ck = dequantize_kv(ck, gather_pages(k_scales, block_tables), q.dtype)
        cv = dequantize_kv(cv, gather_pages(v_scales, block_tables), q.dtype)
    return masked_attention(q, ck, cv, pos)


def masked_attention(q, ck, cv, pos) -> torch.Tensor:
    """q [B, T, H, D] at positions pos[b]..pos[b]+T-1 against contiguous
    K/V rows [B, S, Hkv, D] (a dense cache, or the gathered page view):
    f32 scores, key j of row b valid iff j <= pos[b] + i, softmax, the
    weights cast to the cache dtype for the value product, as the JAX
    package's ``_cached_attention``. ``pos`` is a [B] tensor or a scalar
    (every row at one position). Returns [B, T, H, D] in cv's dtype."""
    b, t, h, d = q.shape
    s, hkv = ck.shape[1], ck.shape[2]
    if hkv != h:
        ck = ck.repeat_interleave(h // hkv, dim=2)
        cv = cv.repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), ck.float()) / (d**0.5)
    qpos = torch.arange(t, device=q.device)
    kpos = torch.arange(s, device=q.device)
    pos = torch.as_tensor(pos, device=q.device).long().reshape(-1)
    valid = kpos[None, None, :] <= (
        pos.expand(b)[:, None, None] + qpos[None, :, None]
    )  # [B, T, S]
    scores = torch.where(valid[:, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(cv.dtype)
    return torch.einsum("bhts,bshd->bthd", w, cv)


def paged_decode_attention_reference(q, k_pages, v_pages, block_tables,
                                     lengths, k_scales=None,
                                     v_scales=None) -> torch.Tensor:
    """Plain PyTorch version of K3 and (with scales) K4:
    ``gather_attention`` at the T = 1 shape (as the JAX package's
    reference restates its decode gather branch); [B, H, D] -> [B, H, D]
    in q's dtype."""
    out = gather_attention(q[:, None], k_pages, v_pages, block_tables,
                           lengths, k_scales, v_scales)
    return out[:, 0].to(q.dtype)


def _split_plan(page: int, n_pages: int, d: int,
                page_dtype: torch.dtype) -> tuple[int, int]:
    """(chunk_tokens, n_splits): the keys each CTA of a row takes, a whole
    number of pages fixed by (page, d, page_dtype) alone, and the CTAs
    per (row, KV head) that cover the table's ``n_pages * page`` keys. A
    row's partition so depends only on its own length, whatever the batch
    or the table's width."""
    tokens = max(1, CHUNK_K_BYTES // (d * page_dtype.itemsize))
    chunk_pages = min(-(-tokens // page), _MAX_CHUNK_PAGES)
    chunk = chunk_pages * page
    return chunk, -(-(n_pages * page) // chunk)


def paged_decode_attention_split_reference(q, k_pages, v_pages,
                                           block_tables, lengths,
                                           k_scales=None,
                                           v_scales=None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, for the CPU tests: each
    row's keys cut by ``_split_plan`` into chunks; per chunk, f32 scores
    q.k (times the K scale for int8 pages) times log2(e)/sqrt(D), its max
    m, l = sum of 2^(s - m) and acc = sum of 2^(s - m) (times the V scale)
    v; the chunks combined in split order into acc / l, rounded once to
    q's dtype. Keys past a row's depth weigh exactly 0 and their values
    are never multiplied. [B, H, D] -> [B, H, D]."""
    b, h, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    n_pages = block_tables.shape[1]
    g = h // hkv
    chunk, n_splits = _split_plan(page, n_pages, d, k_pages.dtype)
    s_len = n_splits * chunk
    dev = q.device
    n_tok = torch.clamp(lengths.long() + 1, 0, n_pages * page)
    valid = torch.arange(s_len, device=dev)[None] < n_tok[:, None]  # [B, S]

    def rows(pool, fill):
        """The row's keys [B, S, Hkv(, D)] in f32, ``fill`` past its depth
        (and past the table) — never the pool's contents there."""
        if pool is None:
            return torch.full((b, s_len, hkv), fill, device=dev)
        x = gather_pages(pool, block_tables).float()
        pad = torch.full((b, s_len - x.shape[1], *x.shape[2:]), fill,
                         device=dev)
        x = torch.cat([x, pad], 1)
        return torch.where(valid.reshape(b, s_len, *[1] * (x.dim() - 2)),
                           x, fill)

    k, v = rows(k_pages, 0.0), rows(v_pages, 0.0)  # [B, S, Hkv, D]
    ks, vs = rows(k_scales, 1.0), rows(v_scales, 1.0)  # [B, S, Hkv]
    qf = q.float().reshape(b, hkv, g, d)
    scale_log2 = torch.tensor(1.0 / d**0.5, dtype=torch.float32,
                              device=dev) * math.log2(math.e)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k) * ks.permute(0, 2, 1)[
        :, :, None] * scale_log2
    mask = valid[:, None, None]
    s = torch.where(mask, s, NEG_INF).reshape(b, hkv, g, n_splits, chunk)
    m = s.amax(-1)  # [B, Hkv, G, n_splits]
    p = torch.where(mask.reshape(b, 1, 1, n_splits, chunk),
                    torch.exp2(s - m[..., None]), 0.0)
    l_part = p.sum(-1)
    pv = p * vs.permute(0, 2, 1).reshape(b, hkv, 1, n_splits, chunk)
    acc = torch.einsum("bkgnc,bnckd->bkgnd", pv,
                       v.reshape(b, n_splits, chunk, hkv, d))
    # Splits past a row's depth do not exist in the kernel: drop them.
    active = torch.clamp(-(-n_tok // chunk), min=1)  # [B]
    live = torch.arange(n_splits, device=dev)[None] < active[:, None]
    m = torch.where(live[:, None, None], m, NEG_INF)
    mx = m.amax(-1, keepdim=True)
    c = torch.where(live[:, None, None], torch.exp2(m - mx), 0.0)
    lsum = (l_part * c).sum(-1)
    o = (acc * c[..., None]).sum(-2) / torch.clamp(lsum, min=1e-30)[..., None]
    return o.reshape(b, h, d).to(q.dtype)


def _workspace(device: torch.device, n_floats: int,
               n_counters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The workspace of ``device``'s current stream, grown to at least
    ``n_floats`` f32 partials and ``n_counters`` int32 counters (a grown
    counter array starts zeroed; the kernel leaves every counter at 0)."""
    stream = (torch.cuda.current_stream(device).cuda_stream
              if device.type == "cuda" else None)
    key = (device, stream)
    work, counters = _workspaces.get(key, (None, None))
    if work is None or work.numel() < n_floats:
        work = torch.empty(max(n_floats, 1), dtype=torch.float32,
                           device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(max(n_counters, 1), dtype=torch.int32,
                               device=device)
    _workspaces[key] = (work, counters)
    return work, counters


def _kernel(q8: bool):
    """The built kernel's C entry point (K3, or K4 when ``q8``), its
    signature declared once (every pointer and the stream as c_void_p, or
    ctypes would cut them to 32 bits)."""
    from pytorch_distributed_tpu_torch.ops import _build

    lib = _build.load("paged_attention")
    fn = (lib.pdt_paged_decode_attention_q8 if q8
          else lib.pdt_paged_decode_attention)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (10 if q8 else 8) + [
            ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    return fn


def _check_scales(q, k_pages, v_pages, k_scales, v_scales) -> None:
    if (k_scales is None) != (v_scales is None):
        raise ValueError(
            "k_scales and v_scales must be given together (int8 pages) or "
            "both omitted (full-precision pages)"
        )
    if k_scales is None:
        if not (q.dtype == k_pages.dtype == v_pages.dtype):
            raise ValueError(
                f"q, k_pages and v_pages must share a dtype, got {q.dtype}, "
                f"{k_pages.dtype}, {v_pages.dtype}"
            )
        return
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise ValueError(
            f"with scales the pages must be int8, got {k_pages.dtype} and "
            f"{v_pages.dtype}"
        )
    want = tuple(k_pages.shape[:3])
    for name, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
        if tuple(sc.shape) != want or sc.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 [P, page, Hkv] = {list(want)}, got "
                f"{sc.dtype} {list(sc.shape)}"
            )


def _check(q, k_pages, v_pages, block_tables, lengths, k_scales,
           v_scales) -> None:
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(
            f"expected q [B, H, D] and pools [P, page, Hkv, D], got "
            f"{tuple(q.shape)} and {tuple(k_pages.shape)}"
        )
    b, h, d = q.shape
    n_pool, page, hkv, dk = k_pages.shape
    if v_pages.shape != k_pages.shape:
        raise ValueError(
            f"k_pages {tuple(k_pages.shape)} and v_pages "
            f"{tuple(v_pages.shape)} differ"
        )
    if dk != d:
        raise ValueError(f"head dim of q ({d}) and pools ({dk}) differ")
    if h % hkv:
        raise ValueError(
            f"query heads {h} must be a multiple of kv heads {hkv}"
        )
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(
            f"block_tables must be [B={b}, n_pages], got "
            f"{tuple(block_tables.shape)}"
        )
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [B={b}], got {tuple(lengths.shape)}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(
            f"block_tables and lengths must be int32, got "
            f"{block_tables.dtype} and {lengths.dtype}"
        )
    _check_scales(q, k_pages, v_pages, k_scales, v_scales)
    tensors = (q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales)
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, D], one query token per row
    k_pages: torch.Tensor,  # [P, page, Hkv, D]
    v_pages: torch.Tensor,  # [P, page, Hkv, D]
    block_tables: torch.Tensor,  # [B, n_pages] int32 page ids
    lengths: torch.Tensor,  # [B] int32: the row's position (keys <= it valid)
    k_scales: torch.Tensor | None = None,  # [P, page, Hkv] f32 (int8 pages)
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Paged single-query attention, [B, H, D] -> [B, H, D] in q's dtype.
    Key j of row b is attended iff j <= lengths[b] (lengths >= 0); K/V
    slots past a row's depth are never read by the kernel (pages a row has
    not reached may hold anything, NaN included). Page ids must lie in
    [0, P): a CPU call raises otherwise, and the kernel, which cannot
    check without a device sync, clamps them into the pool (as a JAX
    gather does) so it never reads out of bounds.

    ``k_scales``/``v_scales`` (both or neither) select K4: int8 pages,
    dequantized by their per-token, per-KV-head f32 scales in the
    kernel.

    On CUDA the kernel splits each row into ``_split_plan`` chunks and
    combines them in the same launch through the workspace of the current
    stream (``_workspace``): one launch, nothing allocated but the output
    once the workspace has grown to the largest batch seen on that
    stream."""
    _check(q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales)
    q8 = k_scales is not None
    if q.device.type == "cpu":
        n_pool = k_pages.shape[0]
        if block_tables.numel() and (
            int(block_tables.min()) < 0 or int(block_tables.max()) >= n_pool
        ):
            raise ValueError(
                f"block_tables holds page ids outside [0, {n_pool})"
            )
        return paged_decode_attention_reference(
            q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention runs on cuda (kernel) or cpu (plain "
            f"version), got device {q.device}"
        )
    b, h, d = q.shape
    n_pool, page, hkv, _ = k_pages.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the kernel takes {sorted(map(str, _DTYPE_CODES))}, got {q.dtype}"
        )
    if d not in _HEAD_DIMS or h // hkv not in _GROUPS:
        raise ValueError(
            f"the kernel takes head_dim in {_HEAD_DIMS} and query-head "
            f"groups in {_GROUPS}, got head_dim {d}, group {h // hkv}"
        )
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    scales = (k_scales, v_scales) if q8 else ()
    if not all(t.is_contiguous() for t in tensors + scales):
        raise ValueError("the kernel takes contiguous tensors only")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q and the pools must be 16-byte aligned")
    fn = _kernel(q8)
    n_pages = block_tables.shape[1]
    chunk, n_splits = _split_plan(page, n_pages, d, k_pages.dtype)
    # Partials [B, Hkv, n_splits] x G x (D + 2) floats, one counter per
    # (row, KV head).
    work, counters = _workspace(q.device, b * h * n_splits * (d + 2),
                                b * hkv)
    out = torch.empty_like(q)
    pointers = [t.data_ptr() for t in (q, k_pages, v_pages, *scales,
                                       block_tables, lengths, out, work,
                                       counters)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            *pointers, b, h, hkv, d, n_pool, page, n_pages, chunk // page,
            n_splits, _DTYPE_CODES[q.dtype], 1.0 / (d**0.5), stream,
        )
    if err:
        raise RuntimeError(
            f"paged decode kernel ({'K4' if q8 else 'K3'}) launch failed: "
            f"cudaError {err}"
        )
    _count_launch(q8)
    return out


def _count_launch(q8: bool) -> None:
    """Count one launch of K4 (``q8``) or K3. Under a lock: engines stepped
    on several threads launch at once, and ``+=`` on a module global is a
    read-modify-write that could lose a count."""
    global launches, launches_q8
    with _count_lock:
        if q8:
            launches_q8 += 1
        else:
            launches += 1
