"""ssd_scan's plain backward (``ssd_chunk_bwd_ref``: the explicit formulas
the backward kernel computes) on the CPU, in fp32, from numpy seeds.

It is held to two references: torch autograd of ``ssd_chunk_ref``,
relative L2 <= 1e-5 per gradient (fp32 sum order only), with any of the
four outputs' gradients absent; and, through the port's whole scan
(``ssd_scan``: the chunk Function, whose CPU backward it is, then the
inter-chunk carry and the y_inter product), ``jax.vjp`` of the JAX
package's ``repro.models.mamba2.ssd_chunked``, relative L2 <= 1e-4 per leaf.
A dropped in_decay gradient must fail both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_torch_parity import randn, to_jax, to_torch  # noqa: E402

from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk_ref, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_bwd_ref  # noqa: E402

AUTOGRAD_REL_L2 = 1e-5
JAX_REL_L2 = 1e-4
NAMES = ("x", "dt", "A", "Bm", "Cm")


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(B, S, H, P, N, seed=0):
    """x, dt, A, Bm, Cm as float32 numpy (dt a softplus, A negative)."""
    dt = np.log1p(np.exp(randn(seed + 1, (B, S, H)))).astype(np.float32)
    return (randn(seed, (B, S, H, P), 0.5), dt,
            (-np.exp(np.linspace(0.0, 1.5, H))).astype(np.float32),
            randn(seed + 2, (B, S, N), 0.3), randn(seed + 3, (B, S, N), 0.3))


def _out_shapes(B, S, H, P, N, Q):
    nc = -(-S // Q)
    return [(B, nc, H, Q, P), (B, nc, H, P, N), (B, nc, H, Q), (B, nc, H, 1)]


def _autograd(arrays, Q, grads):
    ins = [to_torch(a).requires_grad_() for a in arrays]
    outs = ssd_chunk_ref(*ins, Q)
    used = [i for i, g in enumerate(grads) if g is not None]
    got = torch.autograd.grad([outs[i] for i in used], ins, [grads[i] for i in used],
                              allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for g, t in zip(got, ins)]


SHAPES = [(2, 48, 3, 8, 16, 16), (2, 45, 3, 8, 12, 16), (1, 20, 2, 4, 8, 32),
          (1, 70, 5, 8, 8, 64)]


@pytest.mark.parametrize("used", [(0, 1, 2, 3), (0,), (1,), (2, 3), (0, 1, 3)],
                         ids=["all", "y", "states", "decays", "no_in_decay"])
@pytest.mark.parametrize("shape", SHAPES, ids=["whole", "ragged", "one_chunk", "heads5"])
def test_plain_backward_matches_autograd(shape, used):
    *dims, Q = shape
    arrays = _inputs(*dims, seed=sum(shape))
    grads = [to_torch(randn(40 + i, s)) if i in used else None
             for i, s in enumerate(_out_shapes(*dims, Q))]
    got = ssd_chunk_bwd_ref(*(to_torch(a) for a in arrays), Q, grads)
    for name, g, w, a in zip(NAMES, got, _autograd(arrays, Q, grads), arrays):
        assert g.shape == a.shape and g.dtype == torch.float32, name
        if not w.any():
            assert not g.any(), name
        else:
            assert rel_l2(g, w) <= AUTOGRAD_REL_L2, (name, rel_l2(g, w))


def _scan_grads(arrays, chunk, dy, dh):
    """The port's scan gradients for y's gradient ``dy`` and the final
    state's ``dh`` (None: the output has none)."""
    ins = [to_torch(a).requires_grad_() for a in arrays]
    y, h = ssd_scan(*ins, chunk=chunk)
    loss = sum((o * to_torch(c)).sum() for o, c in ((y, dy), (h, dh)) if c is not None)
    return torch.autograd.grad(loss, ins)


def _jax_grads(arrays, chunk, dy, dh):
    ys, vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk=chunk), *(to_jax(a) for a in arrays))
    cts = tuple(np.zeros(o.shape, np.float32) if c is None else c for o, c in zip(ys, (dy, dh)))
    return vjp(tuple(to_jax(c) for c in cts))


@pytest.mark.parametrize("outputs", ["both", "y_only", "final_only"])
@pytest.mark.parametrize("shape", SHAPES, ids=["whole", "ragged", "one_chunk", "heads5"])
def test_scan_backward_matches_jax(shape, outputs):
    B, S, H, P, N, Q = shape
    arrays = _inputs(B, S, H, P, N, seed=sum(shape) + 1)
    dy = randn(50, (B, S, H, P)) if outputs != "final_only" else None
    dh = randn(51, (B, H, P, N)) if outputs != "y_only" else None
    got = _scan_grads(arrays, Q, dy, dh)
    for name, g, w in zip(NAMES, got, _jax_grads(arrays, Q, dy, dh)):
        assert rel_l2(g, w) <= JAX_REL_L2, (name, rel_l2(g, w))


def test_checks_fail_a_dropped_in_decay_gradient(monkeypatch):
    B, S, H, P, N, Q = SHAPES[1]
    arrays = _inputs(B, S, H, P, N, seed=7)
    grads = [to_torch(randn(40 + i, s)) for i, s in enumerate(_out_shapes(B, S, H, P, N, Q))]
    want = _autograd(arrays, Q, grads)
    got = ssd_chunk_bwd_ref(*(to_torch(a) for a in arrays), Q, (grads[0], grads[1], None,
                                                                 grads[3]))
    assert max(rel_l2(g, w) for g, w in zip(got, want)) > AUTOGRAD_REL_L2
    dy, dh = randn(50, (B, S, H, P)), randn(51, (B, H, P, N))
    real = ssd_ops.ssd_chunk_bwd
    monkeypatch.setattr(ssd_ops, "ssd_chunk_bwd", lambda ins, chunk, g: real(
        ins, chunk, (g[0], g[1], None, g[3])))
    got = _scan_grads(arrays, Q, dy, dh)
    jax_want = _jax_grads(arrays, Q, dy, dh)
    assert max(rel_l2(g, w) for g, w in zip(got, jax_want)) > JAX_REL_L2
