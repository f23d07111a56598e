"""mfu.decode (model step): model FLOPs of the window's decode steps (every
slot's products, attention up to each step's position) over their host-clock
time and the bf16 peak, in %; steps in and beside the traced slice left out."""
from perfbench import workcount

UNIT, LAYER, MOVES = "%", "model step", "decode_tokens_per_s"


def read(rec):
    if rec["kind"] != "serve":
        return None
    starts, lens = rec["starts"], rec["cache_lens"]
    skip = set(range(rec["traced"][0] - 1, rec["traced"][1] + 1)) if rec["traced"] else set()
    flops = secs = 0.0
    for t in range(len(starts) - 1):
        if t in skip:
            continue
        flops += workcount.decode_step_flops(rec["arch"], rec["active"][t], lens[t])
        secs += starts[t + 1] - starts[t]
    return 100.0 * flops / secs / workcount.PEAK_FLOPS if secs else None
