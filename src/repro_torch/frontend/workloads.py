"""Traced workloads: the port's own kernels and model layers as sim inputs.

The counterpart of `repro.frontend.workloads`: the same six names, example
shapes, dtypes and memory behaviour, traced from the port's PyTorch functions
(the kernels' plain versions in ``kernels/*/ref.py`` and slices of
`repro_torch.models.layers`).  `build_traced_workload` traces + lifts
(`repro_torch.frontend.fx_lift`) + register-allocates one into a `Workload`
the full pipeline (intervals -> ICG -> renumber -> prefetch -> every sim
engine) consumes like any synthetic kernel.

Two of the functions are Python loops in the port where the JAX package
scans (``ssd_ref`` and ``causal_attention``); a trace would unroll them into
a loop-free program of ~1,000 ops.  Their builders trace a scan form of the
same math instead (`ssd_scan_form`, `causal_attention_scan_form`), through
the ``scan`` higher-order op (``torch._higher_order_ops.scan``), as the JAX
builders trace ``lax.scan``.

The spec table is importable without tracing anything: `TRACED_NAMES` feeds
the workload registry, and tracing only happens inside the builders, on
fake tensors (no CUDA).  Lifts are memoized in `repro_torch.core.plan_cache`
keyed by (name, maxregcount, LIFT_REV), so a sweep traces each kernel once
per process.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F
from torch._higher_order_ops.scan import scan_op

from repro_torch.core.plan_cache import cached_value

if TYPE_CHECKING:  # real import stays lazy: repro_torch.workloads imports us back
    from repro_torch.workloads.suite import Workload

DEFAULT_MAXREGCOUNT = 64


@dataclass(frozen=True)
class TracedSpec:
    """What to trace and how the memory system should treat it."""

    name: str
    builder: object          # () -> (fn, example_args)
    l1_hit: float = 0.85
    while_trips: int = 8


def _examples(*specs):
    """Example arguments: empty CPU tensors of these (shape, dtype) pairs
    (tracing reads only their shapes and dtypes)."""
    return tuple(torch.empty(shape, dtype=dtype) for shape, dtype in specs)


# -- scan forms of the port's two loops ----------------------------------------

def _scan(body, init: list, xs: list, consts: list):
    """``body(*carries, *x slices, *consts) -> [*carries, *ys]`` scanned over
    the leading dim of ``xs``: the ``scan`` higher-order op called directly,
    the tensors the body reads passed as its additional inputs (a jaxpr
    scan's consts).  Returns (carries, stacked ys).  Its front end
    ``scan()`` would capture the body with dynamo, which starts CUDA where
    there is a card, and lifting must not."""
    out = scan_op(body, list(init), list(xs), tuple(consts))
    return list(out[:len(init)]), list(out[len(init):])


def ssd_scan_form(x, dt, A, Bm, Cm):
    """`repro_torch.kernels.ssd_scan.ref.ssd_ref` as one scan over the tokens
    (the JAX ``ssd_ref``'s ``lax.scan``): the same recurrence, step for step.

    x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N).
    Returns (y: (B,S,H,P) in x's dtype, final_state: (B,H,P,N) fp32)."""
    from repro_torch.kernels.ssd_scan.ref import decay

    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]

    def step(h, xt, dtt, bt, ct, A):    # (B,H,P,N); (B,H,P), (B,H), (B,N), (B,N)
        dA = decay(dtt * A[None, :])
        upd = torch.einsum("bhp,bn->bhpn", xt * dtt[..., None], bt)
        h = h * dA[..., None, None] + upd
        return [h, torch.einsum("bhpn,bn->bhp", h, ct)]

    init = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    xs = [x.float().transpose(0, 1), dt.float().transpose(0, 1),
          Bm.float().transpose(0, 1), Cm.float().transpose(0, 1)]
    (final,), (ys,) = _scan(step, [init], xs, [A])
    return ys.transpose(0, 1).to(x.dtype), final


def causal_attention_scan_form(q, k, v, q_block: int = 512, q_offset=None):
    """`repro_torch.models.layers.causal_attention` as one scan over the q
    blocks (the JAX function's ``lax.scan``), the block index a scanned input
    as in the JAX ``one_block``; Sq is zero-padded to whole blocks as there.

    q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd)."""
    from repro_torch.models.layers import NEG_INF, _repeat_kv

    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    offset = Skv - Sq if q_offset is None else q_offset
    kT = _repeat_kv(k, H).permute(0, 2, 3, 1).float()     # (B,H,hd,Skv)
    vT = _repeat_kv(v, H).permute(0, 2, 1, 3).float()     # (B,H,Skv,hd)
    kv_pos = torch.arange(Skv, device=q.device)
    q_block = min(q_block, Sq)
    nblk = -(-Sq // q_block)
    pad = nblk * q_block - Sq
    qp = F.pad(q, (0, 0, 0, 0, 0, pad)) if pad else q
    qb = qp.reshape(B, nblk, q_block, H, hd).permute(1, 0, 3, 2, 4)  # (nblk,B,H,qb,hd)

    def one_block(carry, blk_idx, qblk, kT, vT, kv_pos):
        qpos = blk_idx * q_block + torch.arange(q_block, device=q.device) + offset
        logits = torch.matmul(qblk.float(), kT) * scale
        mask = kv_pos[None, :] <= qpos[:, None]
        logits = torch.where(mask, logits, NEG_INF)
        # a scan body may not return its input as is: the carry is cloned
        return [carry.clone(), torch.matmul(torch.softmax(logits, dim=-1), vT)]

    # torch's scan needs a carry where jax's takes None: an unused 0-d one
    carry = torch.zeros((), dtype=torch.float32, device=q.device)
    _, (outs,) = _scan(one_block, [carry], [torch.arange(nblk, device=q.device), qb],
                       [kT, vT, kv_pos])
    out = outs.permute(1, 0, 3, 2, 4).reshape(B, nblk * q_block, H, hd)
    if pad:
        out = out[:, :Sq]
    return out.to(q.dtype)


# -- example builders: () -> (fn, example_args) ---------------------------------

def _matmul():
    from repro_torch.kernels.ltrf_matmul.ref import matmul_ref

    return matmul_ref, _examples(((64, 128), torch.bfloat16), ((128, 64), torch.bfloat16))


def _attention():
    from repro_torch.kernels.flash_attention.ref import attention_ref

    return attention_ref, _examples(((1, 4, 64, 32), torch.float32),
                                    ((1, 2, 64, 32), torch.float32),
                                    ((1, 2, 64, 32), torch.float32))


def _ssd():
    return ssd_scan_form, _examples(((1, 32, 2, 8), torch.float32),
                                    ((1, 32, 2), torch.float32),
                                    ((2,), torch.float32),
                                    ((1, 32, 8), torch.float32),
                                    ((1, 32, 8), torch.float32))


def _rmsnorm():
    from repro_torch.models.layers import rms_norm

    return rms_norm, _examples(((8, 64), torch.float32), ((64,), torch.float32))


def _mlp():
    from repro_torch.models.layers import mlp_block

    def mlp(w_down, w_gate, w_up, x):
        # the params dict's leaves in jax's flattening order (sorted keys)
        return mlp_block({"w_down": w_down, "w_gate": w_gate, "w_up": w_up}, x,
                         kernels=False)

    return mlp, _examples(((128, 64), torch.float32), ((64, 128), torch.float32),
                          ((64, 128), torch.float32), ((1, 8, 64), torch.float32))


def _attn_layer():
    def layer(q, k, v):
        return causal_attention_scan_form(q, k, v, q_block=32)

    return layer, _examples(((1, 64, 4, 32), torch.float32),
                            ((1, 64, 2, 32), torch.float32),
                            ((1, 64, 2, 32), torch.float32))


TRACED_SPECS: dict[str, TracedSpec] = {
    s.name: s for s in (
        TracedSpec("traced_matmul", _matmul, l1_hit=0.9),
        TracedSpec("traced_attention", _attention, l1_hit=0.85),
        TracedSpec("traced_ssd", _ssd, l1_hit=0.8),
        TracedSpec("traced_rmsnorm", _rmsnorm, l1_hit=0.85),
        TracedSpec("traced_mlp", _mlp, l1_hit=0.9),
        TracedSpec("traced_attn_layer", _attn_layer, l1_hit=0.85),
    )
}
TRACED_NAMES: tuple[str, ...] = tuple(TRACED_SPECS)


def build_traced_workload(name: str,
                          maxregcount: int = DEFAULT_MAXREGCOUNT) -> Workload:
    """Trace, lift, and register-allocate one traced workload (memoized)."""
    spec = TRACED_SPECS[name]

    def build() -> "Workload":
        from repro_torch.workloads.suite import Workload

        from .fx_lift import lift_fn
        from .regalloc import allocate_registers

        fn, args = spec.builder()
        lifted = lift_fn(fn, args, name=name, while_trips=spec.while_trips)
        alloc = allocate_registers(lifted.prog, maxregcount=maxregcount)
        return Workload(
            name=name,
            program=alloc.prog,
            trips=lifted.trips,
            register_sensitive=alloc.regs_per_thread > 32,
            regs_per_thread=alloc.regs_per_thread,
            suite="traced",
            l1_hit=spec.l1_hit,
        )

    from .fx_lift import LIFT_REV

    return cached_value(("traced_workload", name, maxregcount, LIFT_REV), build)


def traced_suite(maxregcount: int = DEFAULT_MAXREGCOUNT) -> dict[str, Workload]:
    """All traced workloads (traces on first call, memoized afterwards)."""
    return {n: build_traced_workload(n, maxregcount) for n in TRACED_NAMES}
