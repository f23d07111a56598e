"""Where a DTensor meets code that runs on local tensors: the hand-written
kernels' call sites, and the ops DTensor cannot shard by itself.

Each function here takes DTensors (plain tensors pass as local data),
declares the placements its local function needs on every mesh dimension,
redistributes the inputs to them through ``local_map`` and returns DTensors
with the declared output placements.  The local function is the same one the
unsharded path calls, so a kernel sees local shards and never a DTensor, the
plain path (``kernels=False``) goes through the same placements, and on a
one-rank mesh (where no redistribution moves anything) every result has the
unsharded path's bits.

- ``embedding``: a (V, D) table's rows at the tokens; the vocabulary split
  over ranks takes each rank's rows and sums the ranks.
- ``matmul``: x (..., K) @ w (K, N).  Per mesh dimension: x sharded on a
  leading dimension gathers w there (FSDP: a weight sharded over the batch's
  mesh dimension is all-gathered, as GSPMD gathers it); w sharded on N is
  column-parallel (x replicated, out sharded on N); w sharded on K, or x on
  K, is row-parallel (both on K, out ``Partial``).
- ``attention``: (B, S, H, d) q, k, v.  Batch and query heads stay sharded;
  the sequence and head width are gathered.  K and V stay head-sharded
  where their heads split as the query's do, else they are gathered and each
  rank takes the KV heads its query heads read.
- ``ssd``: the Mamba2 chunked scan, sharded on the batch only.
- ``cross_entropy``: logits sharded on the batch and on the vocabulary; a
  vocabulary split over ranks takes the vocab-parallel form (max, sum of
  exponentials and the label's logit all-reduced over the vocabulary's ranks,
  as Megatron-LM does).  The loss is ``Partial`` over the batch's ranks.
- ``moe``: expert and expert-tensor parallelism.  Experts sharded over a
  mesh dimension stay sharded there, every rank of it routes all tokens and
  runs its own experts, and the output is ``Partial`` over it.  The experts'
  ``d_ff`` split over a mesh dimension stays too (``w_gate`` and ``w_up``
  column-parallel, ``w_down`` row-parallel, as ``matmul`` keeps a dense
  FFN's): every rank of it routes all tokens alike, runs its ``d_ff`` slice
  of every expert, and the output is ``Partial`` over it.  Tokens stay
  batch-sharded only where whole dispatch groups lie on each rank (the
  capacity is per group), else they are gathered, so every token meets the
  experts and capacity the unsharded dispatch gives it.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

R = Replicate()
P = Partial()


def _mesh(*ts):
    return next(t.device_mesh for t in ts if isinstance(t, DTensor))


def _placements(t, mesh) -> tuple:
    if isinstance(t, DTensor):
        return tuple(t.placements)
    return (R,) * mesh.ndim


def _shards(p, dim: int) -> bool:
    return isinstance(p, Shard) and p.dim == dim


def _run(fn, mesh, args, in_placements, out_placements, grad_placements=None):
    """``fn(*locals)`` under ``local_map``: each DTensor argument
    redistributed to its placements (None for a non-tensor argument).
    ``out_placements``: one output's placements, or a list of them for a
    tuple of outputs.  ``grad_placements`` (default ``in_placements``): the
    placements of each argument's local gradient; an argument replicated
    where the work is split (a weight over the batch's ranks, an activation
    over a weight's) has a ``Partial`` gradient there."""
    out = (tuple(list(p) for p in out_placements) if isinstance(out_placements, list)
           else list(out_placements))
    return local_map(fn, out_placements=out, in_placements=in_placements,
                     in_grad_placements=grad_placements or in_placements,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _shard_offset(mesh, placements, dim: int, size: int) -> int:
    """The offset of this rank's even shard of tensor dimension ``dim`` (of
    global ``size``), split over the mesh dimensions that shard it in order."""
    coord = mesh.get_coordinate()
    offset, chunk = 0, size
    for i, p in enumerate(placements):
        if _shards(p, dim):
            chunk //= mesh.size(i)
            offset += coord[i] * chunk
    return offset


def _split_count(mesh, placements, dim: int) -> int:
    return math.prod(mesh.size(i) for i, p in enumerate(placements) if _shards(p, dim))


def gather_last(t):
    """A DTensor with its last dimension whole on every rank (a plain
    tensor as it is)."""
    if not isinstance(t, DTensor):
        return t
    last = t.ndim - 1
    ps = tuple(R if _shards(p, last) else p for p in t.placements)
    return t if ps == tuple(t.placements) else t.redistribute(t.device_mesh, ps)


def unflatten_last(t, *sizes: int):
    """``t.reshape(*t.shape[:-1], *sizes)``: a DTensor sharded on its last
    dimension is first gathered on each mesh dimension whose shards would not
    split ``sizes[0]`` evenly (DTensor refuses such a view)."""
    shape = (*t.shape[:-1], *sizes)
    if isinstance(t, DTensor):
        last = t.ndim - 1
        ps = tuple(R if _shards(p, last) and sizes[0] % _split_count(t.device_mesh, t.placements,
                                                                     last) else p
                   for p in t.placements)
        if ps != tuple(t.placements):
            t = t.redistribute(t.device_mesh, ps)
    return t.reshape(shape)


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

def matmul(local_fn, x, w):
    """``local_fn(x_local, w_local)`` for x (..., K) @ w (K, N)."""
    mesh = _mesh(x, w)
    last = x.ndim - 1
    rows = []        # per mesh dimension: x, w, out, grad x, grad w
    for a, b in zip(_placements(x, mesh), _placements(w, mesh)):
        if isinstance(a, Shard) and a.dim != last:      # batch-like: gather w
            rows.append((a, R, a, a, P))
        elif _shards(b, 1):                             # column-parallel
            rows.append((R, b, Shard(last), P, b))
        elif _shards(b, 0) or _shards(a, last):         # row-parallel
            rows.append((Shard(last), Shard(0), Partial(), Shard(last), Shard(0)))
        else:
            rows.append((R, R, R, R, R))
    in_x, in_w, out, g_x, g_w = zip(*rows)
    return _run(local_fn, mesh, (x, w), (in_x, in_w), out, (g_x, g_w))


# ---------------------------------------------------------------------------
# embedding lookup
# ---------------------------------------------------------------------------

def embedding(table, tokens):
    """``table[tokens]`` for a (V, D) table: tokens' batch shards stay and
    gather the table there; a table split on its rows (the vocabulary) looks
    up its own rows, zero elsewhere, and the output is ``Partial`` over
    those ranks; a table split on D gives an output split on D.  (DTensor's
    own index backward fails on batch-sharded indices in some torch
    releases.)"""
    mesh = _mesh(table, tokens)
    last = tokens.ndim        # the output's D dimension
    rows = []        # per mesh dimension: table, tokens, out, table's gradient
    for i, (a, b) in enumerate(zip(_placements(tokens, mesh), _placements(table, mesh))):
        if isinstance(a, Shard):
            rows.append((R, a, a, P))
        elif _shards(b, 0) and mesh.size(i) > 1:
            rows.append((b, R, P, b))
        elif _shards(b, 1):
            rows.append((b, R, Shard(last), b))
        else:
            rows.append((R, R, R, R))
    in_t, in_y, out, g_t = zip(*rows)
    V = table.shape[0]
    split = _split_count(mesh, in_t, 0) > 1
    v0 = _shard_offset(mesh, in_t, 0, V)

    def local(tl, yl):
        if not split:
            return tl[yl]
        idx = yl - v0
        inside = (idx >= 0) & (idx < tl.shape[0])
        return tl[idx.clamp(0, tl.shape[0] - 1)] * inside[..., None].to(tl.dtype)

    return _run(local, mesh, (table, tokens), (in_t, in_y), out, (g_t, in_y))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def kv_of_head(h: int, n_heads: int, n_kv: int) -> int:
    """The KV head query head h reads (``layers._repeat_kv``'s mapping)."""
    rep = n_heads // n_kv if n_heads % n_kv == 0 else -(-n_heads // n_kv)
    return h // rep


def _attention_layout(mesh, q, k, head_width_split: bool):
    """Per mesh dimension, the placements of q, of k and v, and of k and v's
    gradients; the mesh dimensions that split the head width (with
    ``head_width_split``: K and V sharded on it stay so); and the KV heads
    this rank's query heads read where K and V are gathered (None: all)."""
    H, KV = q.shape[2], k.shape[2]
    in_q, in_kv, g_kv, hd_dims = [], [], [], []
    for i, (a, b) in enumerate(zip(_placements(q, mesh), _placements(k, mesh))):
        m = mesh.size(i)
        if _shards(a, 0):
            row = (a, a, a)
        elif head_width_split and _shards(b, 3):
            row = (b, b, b)
            hd_dims.append(i)
        elif _shards(a, 2) and H % m == 0:
            aligned = _shards(b, 2) and KV % m == 0 and H % KV == 0
            row = (a, b, b) if aligned else (a, R, P)
        else:
            row = (R, R, R)
        in_q.append(row[0])
        in_kv.append(row[1])
        g_kv.append(row[2])
    in_q, in_kv, g_kv = tuple(in_q), tuple(in_kv), tuple(g_kv)
    n_q = H // _split_count(mesh, in_q, 2)
    h0 = _shard_offset(mesh, in_q, 2, H)
    kv_heads = [kv_of_head(h, H, KV) for h in range(h0, h0 + n_q)]
    select = None
    if _split_count(mesh, in_kv, 2) == 1 and n_q < H:
        k0, n_kv = kv_heads[0], len(set(kv_heads))
        contiguous = (n_q % n_kv == 0 and kv_heads
                      == [k0 + j // (n_q // n_kv) for j in range(n_q)])
        select = slice(k0, k0 + n_kv) if contiguous else torch.tensor(kv_heads)
    return in_q, in_kv, g_kv, hd_dims, select


def _take_heads(kl, vl, select):
    if select is None:
        return kl, vl
    return kl[:, :, select], vl[:, :, select]


def attention(local_fn, q, k, v):
    """``local_fn(q, k, v)`` over (B, S, H, d) queries and (B, S, KV, d) keys
    and values, causal, GQA by ``kv_of_head``."""
    mesh = _mesh(q, k, v)
    in_q, in_kv, g_kv, _, select = _attention_layout(mesh, q, k, False)

    def local(ql, kl, vl):
        return local_fn(ql, *_take_heads(kl, vl, select))

    return _run(local, mesh, (q, k, v), (in_q, in_kv, in_kv), in_q, (in_q, g_kv, g_kv))


def decode_attention(local_fn, q, k, v):
    """``local_fn(q, k, v, reduce)`` for one-token decode: (B, 1, H, hd)
    queries against (B, S_max, KV, hd) caches, placed as ``attention``'s; a
    cache sharded on its head width (the 'act_hd' fallback) stays so, the
    query is cut to match, ``reduce`` all-reduces the logits' partial sums
    over those ranks, and the output is sharded on the head width."""
    mesh = _mesh(q, k, v)
    in_q, in_kv, _, hd_dims, select = _attention_layout(mesh, q, k, True)

    def reduce(t):
        for i in hd_dims:
            t = funcol.wait_tensor(funcol.all_reduce(t, "sum", (mesh, i)))
        return t

    def local(ql, kl, vl):
        return local_fn(ql, *_take_heads(kl, vl, select), reduce)

    out = _run(local, mesh, (q, k, v), (in_q, in_kv, in_kv), in_q)
    if not hd_dims:
        return out
    # back off the head width, whose split would not merge into (H * hd)
    H = q.shape[2]
    return out.redistribute(mesh, tuple(
        (Shard(2) if H % mesh.size(i) == 0 else R) if i in hd_dims else p
        for i, p in enumerate(out.placements)))


# ---------------------------------------------------------------------------
# the Mamba2 chunked scan
# ---------------------------------------------------------------------------

def ssd(local_fn, x, dt, A, Bm, Cm, chunk: int):
    """``local_fn(x, dt, A, Bm, Cm, chunk)`` -> (y, final state), sharded on
    the batch only."""
    mesh = _mesh(x, dt, Bm, Cm)
    batch = tuple(p if _shards(p, 0) else R for p in _placements(x, mesh))
    rep = (R,) * mesh.ndim
    g_a = tuple(P if _shards(p, 0) else R for p in batch)
    return _run(local_fn, mesh, (x, dt, A, Bm, Cm, chunk),
                (batch, batch, rep, batch, batch, None), [batch, batch],
                (batch, batch, g_a, batch, batch, None))


def conv(local_fn, x, w, state=None):
    """``local_fn(x, w, state)`` -> (y, new state): the Mamba2 block's
    depthwise causal conv over x (B, S, C) with weights (K, C) and an
    optional carried state (B, K-1, C).  Batch shards stay; channels stay
    sharded where x and w split them alike (the conv never mixes channels);
    the rest is gathered.  (DTensor's own ``pad`` is not used: some torch
    releases give its output one placement on a 2-D mesh.)"""
    mesh = _mesh(x, w, state)
    rows = []        # per mesh dimension: x and state, w, w's gradient
    for a, b in zip(_placements(x, mesh), _placements(w, mesh)):
        if _shards(a, 0):
            rows.append((a, R, P))
        elif _shards(a, 2) and _shards(b, 1):
            rows.append((a, b, b))
        else:
            rows.append((R, R, R))
    in_x, in_w, g_w = zip(*rows)
    in_s = None if state is None else in_x
    return _run(local_fn, mesh, (x, w, state), (in_x, in_w, in_s), [in_x, in_x],
                (in_x, g_w, in_s))


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------

class _VocabParallelCE(torch.autograd.Function):
    """Per-token loss of fp32 logits whose vocabulary is split over ranks:
    the max, the sum of exponentials and the label's logit are all-reduced
    over ``groups``; the backward (softmax minus one-hot) is local."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, groups):
        def all_reduce(t, op):
            for g in groups:
                t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
            return t

        m = all_reduce(logits.amax(-1), "max")
        e = torch.exp(logits - m[..., None])
        s = all_reduce(e.sum(-1), "sum")
        n = logits.shape[-1]
        inside = (labels >= lo) & (labels < lo + n)
        idx = (labels - lo).clamp(0, n - 1)[..., None]
        gold = all_reduce(torch.gather(logits, -1, idx)[..., 0] * inside, "sum")
        ctx.save_for_backward(e / s[..., None], idx, inside)
        return torch.log(s) + m - gold

    @staticmethod
    def backward(ctx, g):
        p, idx, inside = ctx.saved_tensors
        grad = p * g[..., None]
        grad.scatter_add_(-1, idx, -(g * inside)[..., None])
        return grad, None, None, None


def cross_entropy(local_fn, logits, labels):
    """``local_fn(logits, labels)`` (the mean over tokens) over logits
    (..., V) and labels (...), each rank's mean weighted into a ``Partial``
    sum over the batch's ranks."""
    mesh = _mesh(logits, labels)
    last = logits.ndim - 1
    in_l, in_y, out, vocab_groups, n_batch = [], [], [], [], 1
    for i, a in enumerate(_placements(logits, mesh)):
        if _shards(a, 0):
            in_l.append(a)
            in_y.append(a)
            out.append(Partial())
            n_batch *= mesh.size(i)
        elif _shards(a, last) and mesh.size(i) > 1:
            in_l.append(a)
            in_y.append(R)
            out.append(R)
            vocab_groups.append((mesh, i))
        else:
            in_l.append(R)
            in_y.append(R)
            out.append(R)
    in_l = tuple(in_l)
    lo = _shard_offset(mesh, in_l, last, logits.shape[-1])

    def local(ll, yl):
        if vocab_groups:
            loss = _VocabParallelCE.apply(ll.float(), yl.long(), lo, vocab_groups).mean()
        else:
            loss = local_fn(ll, yl)
        return loss / n_batch

    return _run(local, mesh, (logits, labels), (in_l, tuple(in_y)), tuple(out))


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

MOE_WEIGHTS = ("router", "w_gate", "w_up", "w_down")


def moe(local_fn, params, x, groups: int):
    """``local_fn(params, x, groups, expert_range)`` -> (y, aux) for x
    (B, S, D); ``expert_range`` (e0, n) names the experts a rank holds."""
    mesh = _mesh(x, *params.values())
    E, d_ff = params["router"].shape[1], params["w_gate"].shape[2]
    px = _placements(x, mesh)
    pg, pu, pd = (_placements(params[k], mesh) for k in ("w_gate", "w_up", "w_down"))
    dims = range(mesh.ndim)
    expert_dims = [i for i in dims if _shards(pg[i], 0) and E % mesh.size(i) == 0]
    batch_dims = [i for i in dims if _shards(px[i], 0) and i not in expert_dims]
    n_batch = math.prod(mesh.size(i) for i in batch_dims)
    if groups % n_batch:
        batch_dims, n_batch = [], 1
    # the d_ff split stays where the tokens are whole (a weight sharded over
    # the batch's ranks is gathered there, as ``matmul`` gathers it)
    ffn_dims = [i for i in dims if i not in expert_dims and i not in batch_dims
                and mesh.size(i) > 1 and d_ff % mesh.size(i) == 0
                and _shards(pg[i], 2) and _shards(pu[i], 2) and _shards(pd[i], 1)]
    in_x = tuple(px[i] if i in batch_dims else R for i in dims)
    in_up = tuple(Shard(0) if i in expert_dims else Shard(2) if i in ffn_dims else R
                  for i in dims)
    in_down = tuple(Shard(0) if i in expert_dims else Shard(1) if i in ffn_dims else R
                    for i in dims)
    rep = (R,) * mesh.ndim
    summed = expert_dims + ffn_dims         # each rank's y a share of the sum
    out_y = tuple(Shard(0) if i in batch_dims else P if i in summed else R for i in dims)
    # each rank's aux loss, a share of the whole, is Partial wherever the work
    # is split, and so is the gradient of whatever every such rank reads whole
    split = tuple(P if i in batch_dims or i in summed else R for i in dims)
    g_x = tuple(P if i in summed else in_x[i] for i in dims)
    g_up, g_down = (tuple(P if i in batch_dims else w[i] for i in dims) for w in (in_up, in_down))
    n_split = n_batch * _split_count(mesh, in_up, 0) * math.prod(mesh.size(i) for i in ffn_dims)
    n_local = E // _split_count(mesh, in_up, 0)
    expert_range = None if n_local == E else (_shard_offset(mesh, in_up, 0, E), n_local)

    def local(xl, *weights):
        y, aux = local_fn(dict(zip(MOE_WEIGHTS, weights)), xl, groups // n_batch,
                          expert_range)
        return y, aux / n_split

    weights = [params[k] for k in MOE_WEIGHTS]
    return _run(local, mesh, (x, *weights), (in_x, rep, in_up, in_up, in_down), [out_y, split],
                (g_x, split, g_up, g_up, g_down))
