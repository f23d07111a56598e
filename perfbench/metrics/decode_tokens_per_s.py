"""decode_tokens_per_s: every token the engine generated in the window over the window's wall."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    return rec["tokens"] / rec["window_s"]
