"""train_tokens_per_s (``.moe`` and ``.dense``, one bound each): tokens of all
training steps completed in the window, over the window's seconds (host
clock, each step ending in its loss on the host)."""


def read(run):
    m = run["measured"]
    return m["tokens"] / m["window_s"] if m["steps"] else None
