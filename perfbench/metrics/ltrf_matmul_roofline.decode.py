"""ltrf_matmul_roofline.decode (ltrf_matmul kernel): the decode steps'
products' bound over the device time of the ltrf_matmul kernels in the traced
slice, in %."""
from perfbench import readers, workcount

UNIT, LAYER, MOVES = "%", "ltrf_matmul kernel", "decode_tokens_per_s"


def read(rec):
    if rec["kind"] != "serve" or "trace" not in rec:
        return None
    steps = readers.traced_decode_steps(rec)
    bound, launches = workcount.ltrf_bound_s(rec["arch"], rec["slots"])
    return readers.roofline(rec, "ltrf_matmul", steps * bound, steps * launches,
                            readers.counters(rec, ('ltrf_matmul',), steps))
