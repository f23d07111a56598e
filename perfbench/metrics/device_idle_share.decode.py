"""device_idle_share.decode (device): the traced slice's wall not covered by a
device kernel, copy or memset, in %."""
from perfbench import readers

UNIT, LAYER, MOVES = "%", "device", "decode_tokens_per_s"


def read(rec):
    return readers.idle_share(rec) if rec["kind"] == "serve" else None
