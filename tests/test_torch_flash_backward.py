"""flash_attention's plain backward (``flash_bwd_ref``: the explicit formulas
the backward kernel computes) and its forward with the row log-sum-exp
(``attention_lse_ref``), on the CPU, in fp32, from numpy seeds.

Each backward is held to two references: torch autograd of the plain
forward (``attention_ref``), relative L2 <= 1e-5 per gradient (fp32 sum
order only), and ``jax.vjp`` of the JAX package's ``attention_ref``,
relative L2 <= 1e-4 per leaf (two frameworks' fp32 sums).  Planted faults
(a non-causal backward, the GQA group sum dropped, D dropped) must fail.

The plain backward's D = rowsum(dO o O) and dP = dO V^T cancel in
dS = P o (dP - D), so a one-ulp change in a product's rounding moves its
relative L2 to autograd by ~50x.  In a long-lived test worker that had run
other port files (tests/test_torch_sweep.py before it, on one worker, in one
of ~10 runs), the causal single-group case read 1.0e-5 to 1.3e-5 against
its 2.1e-7 in a fresh process: some process state the run leaves behind
changes a product's rounding.  The autograd comparison therefore runs in a
fresh spawned process (the ``fresh`` fixture), the same fp32 computation
on the same inputs, independent of whatever ran in the worker before.
"""
import concurrent.futures
import math
import multiprocessing

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_parity import randn, to_jax, to_torch  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_lse_ref, attention_ref, flash_bwd_ref,
)

AUTOGRAD_REL_L2 = 1e-5
JAX_REL_L2 = 1e-4


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _case(B, H, KV, S, d, seed):
    return (randn(seed, (B, H, S, d)), randn(seed + 1, (B, KV, S, d)),
            randn(seed + 2, (B, KV, S, d)), randn(seed + 3, (B, H, S, d)))


def _autograd(q, k, v, do, causal):
    ins = [to_torch(a).requires_grad_() for a in (q, k, v)]
    attention_ref(*ins, causal).backward(to_torch(do))
    return [t.grad for t in ins]


def _jax_vjp(q, k, v, do, causal):
    _, vjp = jax.vjp(lambda *a: jax_attention_ref(*a, causal=causal),
                     *(to_jax(a) for a in (q, k, v)))
    return vjp(to_jax(do))


def _plain(q, k, v, do, causal, **fault):
    """flash_bwd_ref on the plain forward's O and LSE; ``fault``: the
    planted faults."""
    q, k, v, do = (to_torch(a) for a in (q, k, v, do))
    rep = q.shape[1] // k.shape[1]
    if fault.get("group_sum_dropped"):
        dq, dk, dv = flash_bwd_ref(q, *(t.repeat_interleave(rep, 1) for t in (k, v)),
                                   *attention_lse_ref(q, k, v, causal), do, causal)
        return dq, dk[:, ::rep] * rep, dv[:, ::rep] * rep
    o, lse = attention_lse_ref(q, k, v, causal)
    if fault.get("delta_dropped"):
        o = torch.zeros_like(o)
    if fault.get("not_causal"):
        o, lse = attention_lse_ref(q, k, v, False)
        causal = False
    return flash_bwd_ref(q, k, v, o, lse, do, causal)


CASES = [(2, 4, 4, 40, 16), (2, 4, 2, 40, 16), (1, 8, 2, 33, 32), (2, 4, 1, 37, 16)]


@pytest.fixture(scope="module")
def fresh():
    """One spawned process for the module's autograd comparisons: a fresh
    interpreter, with none of the test worker's state."""
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield pool


def _plain_and_autograd(q, k, v, do, causal):
    """The plain backward and autograd's gradients (numpy), run in ``fresh``."""
    return ([g.numpy() for g in _plain(q, k, v, do, causal)],
            [g.numpy() for g in _autograd(q, k, v, do, causal)])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", CASES, ids=["group1", "group2", "group4", "mqa_ragged"])
def test_plain_backward_matches_autograd_and_jax(shape, causal, fresh):
    q, k, v, do = _case(*shape, seed=sum(shape))
    got, want = fresh.submit(_plain_and_autograd, q, k, v, do, causal).result()
    assert [g.shape for g in got] == [a.shape for a in (q, k, v)]
    for g, w in zip(got, want):
        assert rel_l2(g, w) <= AUTOGRAD_REL_L2
    for g, w in zip(got, _jax_vjp(q, k, v, do, causal)):
        assert rel_l2(g, w) <= JAX_REL_L2


@pytest.mark.parametrize("fault", ["not_causal", "group_sum_dropped", "delta_dropped"])
def test_plain_backward_check_fails_planted_faults(fault):
    q, k, v, do = _case(2, 4, 2, 40, 16, seed=11)
    got = _plain(q, k, v, do, True, **{fault: True})
    want = _autograd(q, k, v, do, True)
    assert max(rel_l2(g, w) for g, w in zip(got, want)) > AUTOGRAD_REL_L2
    assert max(rel_l2(g, w) for g, w in zip(got, _jax_vjp(q, k, v, do, True))) > JAX_REL_L2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 29, 64])
def test_lse_is_the_logsumexp_of_the_scaled_masked_scores(S, causal):
    q, k, v, _ = _case(2, 4, 2, S, 16, seed=S)
    out, lse = attention_lse_ref(*(to_torch(a) for a in (q, k, v)), causal)
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, S)
    kr = np.repeat(k, 2, axis=1)
    scores = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kr) / math.sqrt(16)
    if causal:
        scores = np.where(np.tril(np.ones((S, S), bool)), scores, -np.inf)
    want = torch.logsumexp(torch.from_numpy(scores), dim=-1)
    assert rel_l2(lse, want) <= 1e-6
    torch.testing.assert_close(out, attention_ref(*(to_torch(a) for a in (q, k, v)), causal),
                               rtol=0, atol=0)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_function_backward_on_the_cpu_is_the_plain_backward(group):
    """FlashAttentionFn on CPU tensors: the forward saves the plain O and
    LSE, the backward is flash_bwd_ref on them (the same bits)."""
    q, k, v, do = _case(2, 4, 4 // group, 24, 16, seed=group)
    ins = [to_torch(a).requires_grad_() for a in (q, k, v)]
    flash_attention(*ins).backward(to_torch(do))
    want = _plain(q, k, v, do, True)
    for t, w in zip(ins, want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


def test_jax_reference_is_differentiated_in_fp32():
    q, k, v, do = _case(1, 2, 2, 8, 16, seed=3)
    assert all(g.dtype == jnp.float32 for g in _jax_vjp(q, k, v, do, True))
