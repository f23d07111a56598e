"""The port's serving stack against the JAX package's: greedy tokens from the
ServingEngine identical for the same weights and requests (fp32 smoke
config), and the copied allocator and scheduler behaving exactly as the
reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.serving import allocator as JA, scheduler as JS  # noqa: E402
from repro.serving.engine import ServeConfig as JServeConfig, ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import allocator as TA, scheduler as TS  # noqa: E402
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402


def _engines(arch, sc_kw):
    jcfg = dataclasses.replace(jax_get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    jp, _ = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return (JEngine(jcfg, params=jp, sc=JServeConfig(**sc_kw)),
            ServingEngine(tcfg, params=tp, sc=ServeConfig(**sc_kw), device="cpu"))


def _submit_both(engines, prompts, max_new):
    for eng in engines:
        for p, m in zip(prompts, max_new):
            eng.submit(p, max_new_tokens=m)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-0.6b", "mamba2-1.3b", "zamba2-1.2b",
                                  "granite-moe-3b-a800m", "dbrx-132b", "musicgen-large",
                                  "llava-next-34b", "phi3-medium-14b", "granite-20b"])
def test_greedy_tokens_identical(arch):
    # 7 requests on 4 slots: slots are reused, and (as in the reference) a
    # slot's SSM state is not reset when a new request takes it; the MoE
    # models drop assignments past capacity, which depends on the slot order;
    # musicgen feeds each token to all 4 codebooks and emits codebook 0's
    je, te = _engines(arch, dict(max_len=32, active_slots=4, total_pages=16))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, rng.integers(1, 8)).tolist() for _ in range(7)]
    max_new = [int(rng.integers(2, 10)) for _ in prompts]
    _submit_both((je, te), prompts, max_new)
    want, got = je.run(), te.run()
    assert got == want
    assert sum(map(len, got.values())) == sum(max_new)
    assert te.aau.used_count == je.aau.used_count == 0
    assert [r.rid for r in te.sched.finished] == [r.rid for r in je.sched.finished]


def test_greedy_tokens_identical_with_preemption():
    # 250-token prompts cross the 256-token page boundary mid-flight; with one
    # spare page the youngest active request is preempted and re-admitted
    je, te = _engines("tinyllama-1.1b", dict(max_len=32, active_slots=2, total_pages=3))
    prompts = [[1] * 250, [2] * 250, [3] * 5]
    _submit_both((je, te), prompts, [12, 12, 6])
    want, got = je.run(), te.run()
    assert je.sched.preemptions > 0
    assert te.sched.preemptions == je.sched.preemptions
    assert got == want
    te.aau.check_invariants()
    assert te.aau.used_count == 0


def test_cache_len_clamps_at_max_len():
    # more steps than max_len: the shared cache_len sticks at max_len - 1
    je, te = _engines("tinyllama-1.1b", dict(max_len=6, active_slots=2, total_pages=8))
    _submit_both((je, te), [[5], [6, 7]], [9, 4])
    assert te.run() == je.run()
    assert te.steps == 9


def test_allocator_equals_reference():
    rng = np.random.default_rng(0)
    ja, ta = JA.AddressAllocationUnit(8), TA.AddressAllocationUnit(8)
    held = []
    for _ in range(200):
        if held and rng.random() < 0.45:
            slot = held.pop(int(rng.integers(len(held))))
            ja.free(slot)
            ta.free(slot)
        else:
            owner = int(rng.integers(100))
            a, b = ja.alloc(owner), ta.alloc(owner)
            assert a == b
            if a is not None:
                held.append(a)
        assert list(ta.unused) == list(ja.unused) and ta.occupied == ja.occupied
        ta.check_invariants()
    with pytest.raises(KeyError):
        ta.free(999)


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_equals_reference(seed):
    rng = np.random.default_rng(seed)
    pages, slots = int(rng.integers(3, 8)), int(rng.integers(1, 5))
    js = JS.TwoLevelScheduler(JA.AddressAllocationUnit(pages), active_slots=slots)
    ts = TS.TwoLevelScheduler(TA.AddressAllocationUnit(pages), active_slots=slots)
    assert TS.PAGE_TOKENS == JS.PAGE_TOKENS
    for _ in range(int(rng.integers(4, 12))):
        plen, new = int(rng.integers(1, 600)), int(rng.integers(1, 300))
        js.submit(plen, new)
        ts.submit(plen, new)

    def state(s):
        return ([(r.rid, r.generated, r.pages, r.state) for r in s.active],
                [(r.rid, r.generated, r.pages, r.state) for r in s.waiting],
                [r.rid for r in s.finished], s.preemptions)

    js.admit()
    ts.admit()
    for _ in range(400):
        if not (js.active or js.waiting):
            break
        js.step()
        ts.step()
        assert state(ts) == state(js)
        if not ts.active and ts.waiting:
            break  # a request larger than the pool: both stall identically


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-3b-a800m", "musicgen-large"])
def test_serve_driver_on_cpu(arch):
    stats = serve(arch, n_requests=6, max_new=5, device="cpu")
    assert stats["completed"] == 6 and stats["pages_leaked"] == 0
    assert stats["tokens"] > 0 and stats["steps"] > 0 and stats["device"] == "cpu"


def test_moe_slot_order_is_part_of_the_result():
    """At decode a MoE step's capacity is shared by its slots: the same
    request gets other tokens when its neighbours change (the reference's
    semantics, which the engine keeps by feeding the slots in order)."""
    je, te = _engines("granite-moe-3b-a800m", dict(max_len=32, active_slots=4, total_pages=16))
    _submit_both((je, te), [[1], [2], [3], [4]], [6] * 4)
    want, got = je.run(), te.run()
    assert got == want
    # the last slot loses its assignments to any expert an earlier slot took
    # (capacity 1 at 4 tokens, top-2 of 8 experts); served alone it keeps them
    je2, te2 = _engines("granite-moe-3b-a800m", dict(max_len=32, active_slots=1, total_pages=16))
    _submit_both((je2, te2), [[4]], [6])
    alone_j, alone_t = je2.run(), te2.run()
    assert alone_t == alone_j
    assert alone_t[0] != got[3]
