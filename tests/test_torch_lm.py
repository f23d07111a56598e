"""The port's LM (forward, loss, decode) against the JAX package's, with the
JAX weights carried across by params_from_numpy, on the smoke configs.

fp32 tolerance is 1e-3 / 1e-3: both sides sum in another order in every
layer, and the differences compound over depth.  bf16 uses the _tol table.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parity import assert_close  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import lm as J  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import lm as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402

ARCHS = ["tinyllama-1.1b", "qwen3-0.6b", "mamba2-1.3b", "zamba2-1.2b",
         "granite-moe-3b-a800m", "dbrx-132b", "musicgen-large", "llava-next-34b",
         "phi3-medium-14b", "granite-20b"]
SSM_ARCHS = ["mamba2-1.3b", "zamba2-1.2b"]
NEW_ARCHS = ARCHS[4:]
FP32 = dict(rtol=1e-3, atol=1e-3)


def _configs(arch, dtype):
    jcfg = dataclasses.replace(jax_get_smoke(arch), dtype=dtype, scan_layers=False)
    tcfg = dataclasses.replace(get_smoke(arch), dtype=dtype)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jp, _ = J.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _batch(cfg, B=2, S=16, seed=0):
    """A batch as the data pipeline builds it: audio codes (B, K, S); vlm
    patches (B, n_patches, D) ahead of S tokens, labels 0 at the patches."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        codes = rng.integers(0, cfg.vocab, (B, cfg.n_codebooks, S)).astype(np.int32)
        batch = {"codes": codes, "labels": codes}
    elif cfg.family == "vlm":
        toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        patches = rng.standard_normal((B, cfg.n_patches, cfg.d_model), dtype=np.float32) * 0.02
        batch = {"tokens": toks, "patches": patches,
                 "labels": np.concatenate([np.zeros((B, cfg.n_patches), np.int32), toks], 1)}
    else:
        toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        batch = {"tokens": toks, "labels": toks}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) if v.dtype == np.float32 else torch.from_numpy(v).long()
             for k, v in batch.items()})


def _decode_tokens(cfg, rng, B):
    """One decode step's tokens: (B, 1), or (B, K, 1) for audio."""
    shape = (B, cfg.n_codebooks, 1) if cfg.family == "audio" else (B, 1)
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


def test_params_from_numpy_is_exact():
    jcfg, tcfg = _configs("qwen3-0.6b", "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    assert len(tp["layers"]) == tcfg.n_layers
    np.testing.assert_array_equal(tp["embed"].float().numpy(), np.asarray(jp["embed"], np.float32))
    for i in range(tcfg.n_layers):
        for name in ("wq", "wo", "q_norm"):
            t = tp["layers"][i]["attn"][name]
            j = np.asarray(jp["layers"]["attn"][name][i])
            assert str(t.dtype).split(".")[-1] == j.dtype.name
            np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))
        assert tp["layers"][i]["mlp"]["w_down"].is_contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(tcfg)
    kw = FP32 if dtype == "float32" else {}
    jx, jpos = J.embed_inputs(jp, jcfg, jb)
    tx, tpos = T.embed_inputs(tp, tcfg, tb)
    assert_close(tx, jx, dtype, **kw)
    jh, _ = J.forward(jp, jcfg, jx, jpos)
    th, _ = T.forward(tp, tcfg, tx, tpos)
    assert th.dtype == tcfg.torch_dtype
    assert_close(th, jh, dtype, **kw)
    jloss, jm = J.loss_fn(jp, jb, jcfg)
    tloss, tm = T.loss_fn(tp, tb, tcfg)
    assert np.isfinite(float(tloss))
    assert_close(tloss, jloss, dtype, **kw)
    assert_close(tm["loss"], jm["loss"], dtype, **kw)
    # the plain path (kernels=False) agrees with the kernel wrappers' CPU path
    pl_loss, _ = T.loss_fn(tp, tb, tcfg, kernels=False)
    assert_close(pl_loss, tloss, dtype, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_cache(arch):
    jcfg, tcfg = _configs(arch, "float32")
    jp, tp = _params(jcfg, tcfg, seed=1)
    B, S_max = 3, 8
    jc, _ = J.init_decode_cache(jcfg, B, S_max)
    tc = T.init_decode_cache(tcfg, B, S_max, device="cpu")
    assert tc.keys() == jc.keys()
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
    rng = np.random.default_rng(2)
    decode = jax.jit(lambda p, c, t, n: J.decode_step(p, c, t, n, jcfg))
    for step in range(6):
        toks = _decode_tokens(tcfg, rng, B)
        jl, jc = decode(jp, jc, jnp.asarray(toks), jnp.int32(step))
        tl, tc = T.decode_step(tp, tc, torch.from_numpy(toks).long(), step, tcfg)
        assert tuple(tl.shape) == jl.shape
        assert_close(tl, jl, **FP32)
        for key in jc:                           # every cache entry
            assert_close(tc[key], jc[key], **FP32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(jl[:, -1], -1)))

def _flat(p, prefix=""):
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            for i, layer in enumerate(v):
                out.update(_flat(layer, f"{prefix}{k}.{i}."))
        else:
            out[prefix + k] = v
    return out


def test_init_params_shapes_match_reference():
    jcfg, tcfg = _configs("qwen3-0.6b", "bfloat16")
    jp, _ = J.init_params(jcfg, jax.random.PRNGKey(0))
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ref = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    got, want = _flat(tp), _flat(ref)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_resolves_and_builds(arch):
    """Every id of the registry resolves to the JAX package's configs (full
    and smoke) and builds smoke params with the reference's keys and shapes."""
    full, smoke = get_arch(arch), get_smoke(arch)
    from repro.configs import get_arch as jax_get_arch
    assert dataclasses.asdict(full) == dataclasses.asdict(jax_get_arch(arch))
    assert dataclasses.asdict(smoke) == dataclasses.asdict(jax_get_smoke(arch))
    jcfg, tcfg = _configs(arch, "bfloat16")
    jp, _ = J.init_params(jcfg, jax.random.PRNGKey(0))
    got = _flat(T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    want = _flat(params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert got["lm_head"].shape == (tcfg.d_model, T.head_width(tcfg))



@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_params_shapes_match_reference_ssm_families(arch):
    jcfg, tcfg = _configs(arch, "bfloat16")
    jp, _ = J.init_params(jcfg, jax.random.PRNGKey(0))
    got = _flat(T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    want = _flat(params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    assert got.keys() == want.keys()
    assert ("shared_attn.attn.wq" in got) == (arch == "zamba2-1.2b")
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k


def test_params_from_numpy_is_exact_hybrid():
    """zamba2's layers nest {"mixer": {...}, "norm"}, and its top-level
    shared_attn is a dict: every leaf comes across bit for bit."""
    jcfg, tcfg = _configs("zamba2-1.2b", "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    want = jax.tree.map(np.asarray, jp)
    assert len(tp["layers"]) == tcfg.n_layers
    for name in ("in_proj", "conv", "A_log", "out_proj"):
        for i in range(tcfg.n_layers):
            t, j = tp["layers"][i]["mixer"][name], want["layers"]["mixer"][name][i]
            assert str(t.dtype).split(".")[-1] == j.dtype.name and t.is_contiguous()
            np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))
    for blk, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "w_down"), ("norm1", None)):
        t = tp["shared_attn"][blk] if name is None else tp["shared_attn"][blk][name]
        j = want["shared_attn"][blk] if name is None else want["shared_attn"][blk][name]
        assert str(t.dtype).split(".")[-1] == j.dtype.name
        np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_cache_dtypes_after_first_step(arch):
    """bf16 model: after one step the reference's SSM state is fp32 and the
    conv window (and the hybrid's K/V) stay bf16; the port holds the same."""
    jcfg, tcfg = _configs(arch, "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    jc, _ = J.init_decode_cache(jcfg, 2, 8)
    tc = T.init_decode_cache(tcfg, 2, 8, device="cpu")
    toks = np.array([[3], [7]], np.int32)
    jl, jc = J.decode_step(jp, jc, jnp.asarray(toks), jnp.int32(0), jcfg)
    tl, tc = T.decode_step(tp, tc, torch.from_numpy(toks).long(), 0, tcfg)
    for key in jc:
        assert str(tc[key].dtype).split(".")[-1] == jc[key].dtype.name, key
    assert tc["ssm"].dtype == torch.float32 and tc["conv"].dtype == torch.bfloat16
    assert_close(tl, jl, "bfloat16")
    assert_close(tc["ssm"], jc["ssm"], "bfloat16")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "musicgen-large", "llava-next-34b"])
def test_params_from_numpy_is_exact_new_families(arch):
    """The expert stacks (L, E, D, F) arrive per layer as (E, D, F), the
    router stays fp32, the audio embedding stays a (K, V, D) stack: every
    leaf bit for bit."""
    jcfg, tcfg = _configs(arch, "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    want = jax.tree.map(np.asarray, jp)
    got = _flat(tp)
    flat_want = {}
    for k, v in _flat({k: v for k, v in want.items() if k != "layers"}).items():
        flat_want[k] = v
    for i in range(tcfg.n_layers):
        for k, v in _flat(jax.tree.map(lambda a, i=i: a[i], want["layers"])).items():
            flat_want[f"layers.{i}.{k}"] = v
    assert got.keys() == flat_want.keys()
    for k, j in flat_want.items():
        t = got[k]
        assert str(t.dtype).split(".")[-1] == j.dtype.name and t.is_contiguous(), k
        np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32), err_msg=k)
    if tcfg.family == "moe":
        assert got["layers.0.moe.router"].dtype == torch.float32
        assert got["layers.0.moe.w_gate"].shape == (tcfg.n_experts, tcfg.d_model, tcfg.d_ff)
    if tcfg.family == "audio":
        assert got["embed"].shape == (tcfg.n_codebooks, tcfg.vocab, tcfg.d_model)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "tinyllama-1.1b", "llava-next-34b"])
def test_padded_head_never_reaches_argmax_or_loss(arch):
    """A vocab that is not a multiple of 8 (253): lm_head is held 256 wide
    with zero columns.  Set those columns huge: forward, loss and decode
    still equal the reference's, so the padding never reaches an argmax,
    a softmax or the loss."""
    jcfg, tcfg = _configs(arch, "float32")
    jcfg, tcfg = (dataclasses.replace(c, vocab=253) for c in (jcfg, tcfg))
    jp, tp = _params(jcfg, tcfg)
    head = tp["lm_head"]
    assert head.shape == (tcfg.d_model, 256) and head.is_contiguous()
    assert not head[:, 253:].any()
    np.testing.assert_array_equal(head[:, :253].numpy(), np.asarray(jp["lm_head"]))
    assert T.init_params(tcfg, device="cpu")["lm_head"].shape == (tcfg.d_model, 256)
    head[:, 253:] = 1e4
    jb, tb = _batch(tcfg)
    tl, _ = T.logits_fn(tp, tb, tcfg)
    assert tl.shape[-1] == 253
    jloss, _ = J.loss_fn(jp, jb, jcfg)
    tloss, _ = T.loss_fn(tp, tb, tcfg)
    assert_close(tloss, jloss, **FP32)
    jc, _ = J.init_decode_cache(jcfg, 2, 8)
    tc = T.init_decode_cache(tcfg, 2, 8, device="cpu")
    toks = np.array([[3], [250]], np.int32)
    jl, _ = J.decode_step(jp, jc, jnp.asarray(toks), jnp.int32(0), jcfg)
    tl, _ = T.decode_step(tp, tc, torch.from_numpy(toks).long(), 0, tcfg)
    assert tuple(tl.shape) == jl.shape == (2, 1, 253)
    assert_close(tl, jl, **FP32)
    np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), np.asarray(jnp.argmax(jl[:, -1], -1)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_unpadded_heads_keep_their_shape(arch):
    """Widths that are multiples of 64 are held as they are, full configs
    included (shapes only); others are padded up to the next multiple of 64:
    granite-moe's 49155 is held 49216 wide, mamba2's 50280 50304."""
    cfg = get_arch(arch)
    width = T.head_width(cfg)
    held = T.held_width(width)
    assert held == width if width % 64 == 0 else (held % 64 == 0 and 0 < held - width < 64)
    assert T.pad_head(torch.empty((2, width), device="meta")).shape == (2, held)
    if arch == "granite-moe-3b-a800m":
        assert (width, held) == (49155, 49216)
    if arch == "mamba2-1.3b":
        assert (width, held) == (50280, 50304)


# every config's head at full and smoke width: (true width, held width); only
# granite-moe's and mamba2's full heads are padded
HELD_WIDTHS = {
    "phi3-medium-14b": ((100352, 100352), (256, 256)),
    "tinyllama-1.1b": ((32000, 32000), (256, 256)),
    "granite-20b": ((49152, 49152), (256, 256)),
    "qwen3-0.6b": ((151936, 151936), (512, 512)),
    "granite-moe-3b-a800m": ((49155, 49216), (256, 256)),
    "dbrx-132b": ((100352, 100352), (256, 256)),
    "llava-next-34b": ((64000, 64000), (256, 256)),
    "musicgen-large": ((8192, 8192), (512, 512)),
    "mamba2-1.3b": ((50280, 50304), (256, 256)),
    "zamba2-1.2b": ((32000, 32000), (256, 256)),
}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_held_width_rows_are_whole_128_byte_lines(arch):
    """held_width at every config, full and smoke: the next multiple of 64
    columns (bf16 rows of whole 128-byte lines, which TMA loads fastest),
    and the width itself where it is one; the table lists every config."""
    assert set(HELD_WIDTHS) == set(ARCH_IDS)
    for cfg, want in zip((get_arch(arch), get_smoke(arch)), HELD_WIDTHS[arch]):
        width = T.head_width(cfg)
        assert (width, T.held_width(width)) == want
        assert want[1] % 64 == 0 and 0 <= want[1] - width < 64


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "dbrx-132b"])
def test_moe_aux_loss_is_summed_over_layers(arch):
    """forward's aux is the sum of the layers' MoE aux losses (as the
    reference's unrolled forward), and loss_fn adds 0.01 of it."""
    jcfg, tcfg = _configs(arch, "float32")
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(tcfg)
    jx, jpos = J.embed_inputs(jp, jcfg, jb)
    _, jaux = J.forward(jp, jcfg, jx, jpos)
    tx, tpos = T.embed_inputs(tp, tcfg, tb)
    _, taux = T.forward(tp, tcfg, tx, tpos)
    assert float(taux) > 0
    assert_close(taux, jaux, **FP32)
    total, m = T.loss_fn(tp, tb, tcfg)
    assert_close(total, m["loss"] + 0.01 * m["aux_loss"], rtol=1e-6, atol=1e-6)
    assert_close(m["aux_loss"], jaux, **FP32)


def test_moe_groups_in_forward_and_not_in_decode():
    """forward dispatches cfg.moe_groups token groups; decode_step one."""
    jcfg, tcfg = _configs("granite-moe-3b-a800m", "float32")
    jcfg, tcfg = (dataclasses.replace(c, moe_groups=2) for c in (jcfg, tcfg))
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(tcfg)
    assert_close(T.loss_fn(tp, tb, tcfg)[0], J.loss_fn(jp, jb, jcfg)[0], **FP32)
    jc, _ = J.init_decode_cache(jcfg, 3, 8)
    tc = T.init_decode_cache(tcfg, 3, 8, device="cpu")
    toks = np.array([[1], [2], [3]], np.int32)
    jl, _ = J.decode_step(jp, jc, jnp.asarray(toks), jnp.int32(0), jcfg)
    tl, _ = T.decode_step(tp, tc, torch.from_numpy(toks).long(), 0, tcfg)
    assert_close(tl, jl, **FP32)
