"""Host milliseconds a fused decode step, over the window's rounds
(`inflight_serve`'s decode_s / decode_steps)."""


def read(ctx):
    e = ctx.entry
    if not e.get("decode_steps"):
        return None
    return 1e3 * e["decode_s"] / e["decode_steps"]
