"""The decode step the serving engine captures as a CUDA graph, on the CPU.

``decode_step`` takes ``cache_len`` as a Python int or as a 0-d device
tensor (the graph's scalar, written before every replay).  Held here, on the
ten smoke architectures with the JAX weights carried across by
``params_from_numpy``:

- the tensor gives the int's bits (logits and every cache entry) at
  ``cache_len`` 0, mid-cache, ``max_len - 1`` and past ``max_len``;
- the JAX ``decode_step`` jitted with a traced ``cache_len`` equals the
  port's with a tensor one, within ``test_torch_lm``'s fp32 tolerances;
- nothing on the step's path reads a tensor on the host (a read would sync a
  replayed step, or bake one step's value into the graph): the step runs
  under a ``TorchFunctionMode`` that raises on every such read;
- the KV write places its row as ``dynamic_update_slice`` does (a negative
  row counted from the end, then clamped to the cache).
"""
import dataclasses
import math
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parity import assert_close, randn, to_jax, to_torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as J  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

B, S_MAX = 3, 8
CACHE_LENS = (0, S_MAX // 2, S_MAX - 1, S_MAX + 3)
FP32 = dict(rtol=1e-3, atol=1e-3)           # test_torch_lm's


@lru_cache(maxsize=None)
def _configs(arch, dtype):
    jcfg = dataclasses.replace(jax_get_smoke(arch), dtype=dtype, scan_layers=False)
    return jcfg, dataclasses.replace(get_smoke(arch), dtype=dtype)


@lru_cache(maxsize=None)
def _params(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    jp, _ = J.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _tokens(cfg, rng):
    shape = (B, cfg.n_codebooks, 1) if cfg.family == "audio" else (B, 1)
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


def _filled_cache(cfg, seed):
    """A decode cache of random values (every row of it differs from a fresh
    write), made with numpy."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(tuple(t.shape), dtype=np.float32)).to(t.dtype)
            for k, t in T.init_decode_cache(cfg, B, S_MAX, "cpu").items()}


@pytest.mark.parametrize("cache_len", CACHE_LENS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tensor_cache_len_gives_the_int_bits(arch, cache_len):
    _, tcfg = _configs(arch, get_smoke(arch).dtype)
    _, tp = _params(arch, tcfg.dtype)
    toks = torch.from_numpy(_tokens(tcfg, np.random.default_rng(cache_len))).long()
    cache = _filled_cache(tcfg, 1)
    got_cache = {k: t.clone() for k, t in cache.items()}
    want, want_cache = T.decode_step(tp, cache, toks, cache_len, tcfg)
    got, got_cache = T.decode_step(tp, got_cache, toks, torch.tensor(cache_len), tcfg)
    assert torch.equal(got, want)
    assert got_cache.keys() == want_cache.keys()
    for key in want_cache:
        assert torch.equal(got_cache[key], want_cache[key]), key


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_jax_decode_with_a_traced_cache_len_matches(arch):
    jcfg, tcfg = _configs(arch, "float32")
    jp, tp = _params(arch, "float32")
    jc, _ = J.init_decode_cache(jcfg, B, S_MAX)
    tc = T.init_decode_cache(tcfg, B, S_MAX, device="cpu")
    decode = jax.jit(lambda p, c, t, n: J.decode_step(p, c, t, n, jcfg))
    rng = np.random.default_rng(2)
    for step in (0, 1, 2, 5, 7, 9):             # 9: past the cache, the write clamps
        toks = _tokens(tcfg, rng)
        jl, jc = decode(jp, jc, jnp.asarray(toks), jnp.int32(step))
        tl, tc = T.decode_step(tp, tc, torch.from_numpy(toks).long(), torch.tensor(step), tcfg)
        assert_close(tl, jl, **FP32)
        for key in jc:
            assert_close(tc[key], jc[key], **FP32)


HOST_READS = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.__int__,
              torch.Tensor.__float__, torch.Tensor.__index__, torch.Tensor.tolist,
              torch.Tensor.numpy, torch.Tensor.cpu}


class HostReadError(AssertionError):
    pass


class NoHostReads(TorchFunctionMode):
    """Raises on every read of a tensor's value on the host."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in HOST_READS:
            raise HostReadError(f"{func.__name__} read a tensor on the host")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_reads_nothing_on_the_host(arch):
    _, tcfg = _configs(arch, get_smoke(arch).dtype)
    _, tp = _params(arch, tcfg.dtype)
    toks = torch.from_numpy(_tokens(tcfg, np.random.default_rng(0))).long()
    cache, n = _filled_cache(tcfg, 3), torch.tensor(S_MAX // 2)
    with NoHostReads():                         # the guard itself catches each read
        for read in (lambda: int(n), lambda: bool(n > 1), lambda: toks[:int(n)],
                     lambda: n.item(), lambda: min(n, 4), lambda: n.cpu()):
            with pytest.raises(HostReadError):
                read()
        logits, _ = T.decode_step(tp, cache, toks, n, tcfg)
        nxt = logits[:, -1].argmax(dim=-1)       # the engine's greedy tokens, in the graph
    assert nxt.shape[0] == B


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("cache_len", [-2, 0, 5, S_MAX - 1, S_MAX, S_MAX + 4])
def test_cache_write_clamps_as_dynamic_update_slice(cache_len, as_tensor):
    D, H, KV, HD = 32, 4, 2, 8
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD)
    p = {"wq": randn(0, (D, H * HD), 1 / math.sqrt(D)), "wk": randn(1, (D, KV * HD), 1 / math.sqrt(D)),
         "wv": randn(2, (D, KV * HD), 1 / math.sqrt(D)), "wo": randn(3, (H * HD, D), 0.1)}
    x = randn(4, (B, 1, D))
    ck, cv = randn(5, (B, S_MAX, KV, HD)), randn(6, (B, S_MAX, KV, HD))
    # the row the reference writes: dynamic_update_slice counts a negative
    # start from the end once, then clamps it (-2 writes row 6, 12 row 7)
    marker = jax.lax.dynamic_update_slice_in_dim(jnp.zeros(S_MAX), jnp.ones(1), cache_len, 0)
    want_rows = np.flatnonzero(np.asarray(marker)).tolist()
    want, jk, jv = JL.attention_decode({k: to_jax(v) for k, v in p.items()}, to_jax(x),
                                       to_jax(ck), to_jax(cv), jnp.int32(cache_len), **kw)
    n = torch.tensor(cache_len) if as_tensor else cache_len
    got, tk, tv = TL.attention_decode({k: to_torch(v) for k, v in p.items()}, to_torch(x),
                                      to_torch(ck), to_torch(cv), n, **kw)
    for new, old in ((tk, ck), (tv, cv)):
        rows = np.flatnonzero((new.numpy() != old).any(axis=(0, 2, 3))).tolist()
        assert rows == want_rows and len(rows) == 1
    assert_close(tk, jk, rtol=2e-4, atol=1e-4)
    assert_close(tv, jv, rtol=2e-4, atol=1e-4)
    assert_close(got, want, rtol=2e-4, atol=1e-4)
