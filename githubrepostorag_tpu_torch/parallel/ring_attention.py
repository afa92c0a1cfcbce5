"""Ring attention: causal GQA attention with the sequence axis sharded over
the ``sp`` mesh axis; port of ``githubrepostorag_tpu/parallel/ring_attention.py``.

Each rank keeps its contiguous sequence shard of Q resident and streams the
K/V shards around the ring: step ``s`` folds the block owned by rank
``(i - s) mod n`` into an online (streaming) softmax while ``ppermute``
(``parallel/collectives.py``) rotates the K/V blocks one hop.  No rank
holds the full [S, S] scores or the full K/V.

JAX writes the body once inside ``shard_map`` over global arrays; here both
functions take this rank's local shards.  Gradients need no hand-written
backward: autograd runs the reverse ring through ``ppermute``'s backward
(the inverse permutation), as JAX transposes ``lax.ppermute``.

Heads: JAX shards heads over tp inside the ring only when tp divides both
head counts (``shard_heads``), and otherwise keeps every head replicated
in the ring.  Per head the attention is the same either way, so here the
ring always runs on the heads this rank owns: its query shard and the K/V
heads those queries read (``kv_group``), which is JAX's replicated result
restricted to this rank's heads, without the tp-fold recompute.
"""

from __future__ import annotations

import torch

from githubrepostorag_tpu_torch.ops.attention import dense_attention
from githubrepostorag_tpu_torch.parallel.collectives import ppermute

NEG_INF = -1e30


def ring_attention(
    q: torch.Tensor,  # [B, S_loc, n_q, hd]  this rank's query shard
    k: torch.Tensor,  # [B, S_loc, n_kv, hd] this rank's K shard
    v: torch.Tensor,  # [B, S_loc, n_kv, hd]
    seg: torch.Tensor | None = None,  # [B, S_loc] per-token segment ids
    *,
    mesh,
    axis_name: str = "sp",
    causal: bool = True,
) -> torch.Tensor:
    """The ring over ``mesh``'s ``axis_name`` group.  Sequence shards are
    contiguous: rank ``i`` of the axis owns global positions
    [i*S_loc, (i+1)*S_loc).  Returns the local attention output
    [B, S_loc, n_q, hd] in q.dtype; softmax runs in float32.

    ``seg`` packs many sequences into one ring pass: tokens attend only
    within their own segment id (and causally, when ``causal``).  The
    kv-side segment shard rotates around the ring with its K/V block.
    Padding tokens carry a sentinel id; their rows are garbage and the
    caller never samples them."""
    n = mesh.shape[axis_name]
    group = mesh.group(axis_name)
    my = mesh.coords[axis_name]
    b, sq, n_q, hd = q.shape
    n_kv = k.shape[2]
    g = n_q // n_kv
    scale = 1.0 / (hd**0.5)
    dev = q.device

    q_pos = my * sq + torch.arange(sq, device=dev)  # global positions of local queries
    qg = q.reshape(b, sq, n_kv, g, hd).float()

    # online-softmax state, laid out [B, n_kv, g, Sq(, hd)] like ops.attention
    m = torch.full((b, n_kv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n_kv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n_kv, g, sq, hd), dtype=torch.float32, device=dev)

    perm = [(j, (j + 1) % n) for j in range(n)]
    k_blk, v_blk, seg_blk = k, v, seg  # the segment ids rotate with their block
    for step in range(n):
        owner = (my - step) % n  # whose block this rank holds this step
        kv_pos = owner * sq + torch.arange(sq, device=dev)

        scores = torch.einsum("bsngh,btnh->bngst", qg, k_blk.float()) * scale
        invalid = None  # [B or 1, Sq, Sk]
        if causal:
            invalid = (kv_pos[None, :] > q_pos[:, None])[None]
        if seg is not None:
            cross = seg[:, :, None] != seg_blk[:, None, :]
            invalid = cross if invalid is None else invalid | cross
        if invalid is not None:
            scores = scores.masked_fill(invalid[:, None, None], NEG_INF)

        new_m = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - new_m)  # rescale of the earlier accumulation
        p = torch.exp(scores - new_m[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bngst,btnh->bngsh", p, v_blk.float())
        m = new_m

        if step < n - 1:
            k_blk = ppermute(k_blk, group, perm)
            v_blk = ppermute(v_blk, group, perm)
            if seg_blk is not None:
                seg_blk = ppermute(seg_blk, group, perm)

    # causal masking alone lets every query see itself at step 0, so l > 0;
    # under segment masking a row can be fully masked: guard the divide (the
    # where is bit-identical to the plain divide wherever l > 0)
    l = torch.where(l == 0.0, 1.0, l)
    out = acc / l[..., None]  # [B, n_kv, g, Sq, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, n_q, hd).to(q.dtype)


def make_ring_attend(
    mesh,
    *,
    num_heads: int,
    num_kv_heads: int,
    axis_name: str = "sp",
    causal: bool = True,
    segmented: bool = False,
):
    """``attend(q, k, v)`` over this rank's shards: sequence over
    ``axis_name``, batch over dp, heads as ``kv_group`` leaves them.
    ``segmented=True`` returns ``attend(q, k, v, seg)`` instead, ``seg``
    [B, S_loc] per-token segment ids sharded like the sequence.

    ``num_heads`` / ``num_kv_heads`` are the model's (global) counts: each
    call checks the local ones against the tp split ``kv_group`` gives."""
    n = mesh.shape[axis_name]
    tp = mesh.shape.get("tp", 1)
    want_q = num_heads // tp if num_heads % tp == 0 else num_heads

    def check(q):
        if q.shape[2] != want_q:
            raise ValueError(f"ring attention over tp={tp} takes {want_q} query heads a rank, "
                             f"got {q.shape[2]}")

    if n == 1 and not segmented:
        # degenerate ring: no ppermute
        def attend(q, k, v):
            check(q)
            return dense_attention(q, k, v, causal=causal, q_offset=0)
        return attend

    if segmented:
        def attend_seg(q, k, v, seg):
            check(q)
            return ring_attention(q, k, v, seg, mesh=mesh, axis_name=axis_name, causal=causal)
        return attend_seg

    def attend(q, k, v):
        check(q)
        return ring_attention(q, k, v, mesh=mesh, axis_name=axis_name, causal=causal)
    return attend


def kv_group(k: torch.Tensor, mesh, num_heads: int, num_kv_heads: int) -> torch.Tensor:
    """The K (or V) heads [B, S, h, hd] this rank's query heads read, from
    ``k`` as the tp-sharded projection gives it.  JAX's rule: heads shard
    over tp when tp divides both counts (``k`` is already this rank's
    shard); when tp divides the query heads only, the K/V projections stay
    replicated and each of this rank's query heads keeps the K/V head of
    its group (a query shard then never holds a whole group); when tp
    divides neither, every head is replicated and so is ``k``."""
    tp = mesh.shape.get("tp", 1)
    shard_heads = tp > 1 and num_heads % tp == 0 and num_kv_heads % tp == 0
    if tp == 1 or shard_heads or num_heads % tp:
        return k
    nq_loc = num_heads // tp
    heads = mesh.coords["tp"] * nq_loc + torch.arange(nq_loc, device=k.device)
    return k.index_select(2, heads // (num_heads // num_kv_heads))
