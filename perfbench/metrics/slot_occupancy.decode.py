"""slot_occupancy.decode (serving engine loop): tokens generated over steps
times slots, in % (requests waiting while a slot idles would lower it)."""
UNIT, LAYER, MOVES = "%", "serving engine loop", "decode_tokens_per_s"


def read(rec):
    if rec["kind"] != "serve" or not rec["steps"]:
        return None
    return 100.0 * rec["tokens"] / (rec["steps"] * rec["slots"])
