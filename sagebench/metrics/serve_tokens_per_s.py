"""Prompt and generated tokens of every request of the window over the
window's length."""


def read(rec):
    return sum(u["batch"] * (u["prompt_len"] + u["gen"])
               for u in rec.units) / rec.window_s
